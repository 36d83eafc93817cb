"""The port's pose and ID trainers (``macaque_tpu_torch/nn/train.py``,
``nn/optim.py``, the training mode of ``nn/layers.py``) against the JAX
package's ``nn/train.py`` and optax, on the CPU, with the same numpy inputs
and the weights carried by ``vitpose_from_jax`` / ``resnet_from_jax``.
Updated JAX parameters are compared after the same conversion.

Tolerances (float32 both sides, found values in brackets):
  * UDP heatmaps within 1e-6 [6e-8], weights equal; the MSE and
    label-smoothing losses within 1e-6 relative (JAX computes the smoothed
    targets in float64 with x64 on);
  * schedule values within 1e-12 relative (float64 both sides); layer ids
    and decay sets equal;
  * one optimizer update within 1e-6 relative + 1e-9 (the global norm sums
    the leaves in another order);
  * 3 pose steps: losses within 2e-6 relative [2e-7], parameters within
    5e-6 [1.1e-6] and BatchNorm statistics within 1e-6 [6e-8], except the
    key bias of each qkv layer: its true gradient is 0 (a softmax does not
    see a shift shared by a row's logits), so both sides' gradients are
    float noise below Adam's eps that Adam scales up, and it is held to
    1e-4 [2e-5], within the 3 steps' learning rates;
  * 3 ID steps: losses within 1e-5 relative [8e-7], parameters within 3e-5
    [8e-6], statistics within 1e-5 [1.6e-6].

The ID steps start from mmpretrain's ResNet init with zero residual
scales (``zero_init_residual``: every bottleneck's last BatchNorm scale 0)
and take plain SGD (``optax.sgd`` against the port's
``scale_by_learning_rate``). From a random init with every scale 1, a
ResNet-50 in training mode is chaotic: float32 rounding alone moves its
gradient by 2% (the port in float32 against the port in float64: 2.0%,
the JAX package against the same float64 run: 2.2%), and Adam's first
step, which divides each gradient by its own magnitude, turns that into
sign flips of lr; neither package can then hold the other. The optimizer
chains are compared on their own, above."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from macaque_tpu import nn as jnn
from macaque_tpu.nn import train as jtrain
from macaque_tpu_torch import nn as tnn
from macaque_tpu_torch.nn import optim
from macaque_tpu_torch.nn import train as ttrain
from macaque_tpu_torch.nn.convert import resnet_from_jax, vitpose_from_jax
from macaque_tpu_torch.nn.layers import BatchNorm2d, Linear, make_trainable

TINY_VIT = dict(img_size=(64, 48), embed_dim=32, depth=2, num_heads=2,
                deconv_channels=(8, 8))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ targets, losses

def test_udp_encode_matches_jax():
    rng = np.random.default_rng(0)
    kps = rng.uniform(-20, 210, (3, 17, 2)).astype(np.float32)
    kps[0, 3] = [500.0, 50.0]                              # outside
    vis = (rng.uniform(0, 1, (3, 17)) > 0.2).astype(np.float32)
    jh, jw = jtrain.udp_encode(jnp.asarray(kps), jnp.asarray(vis))
    th, tw = ttrain.udp_encode(torch.from_numpy(kps), torch.from_numpy(vis))
    assert th.shape == (3, 64, 48, 17)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-6)
    assert tw[0, 3] == 0 and th[0, ..., 3].max() == 0


def test_keypoint_mse_and_label_smooth_losses_match_jax():
    rng = np.random.default_rng(1)
    pred = rng.normal(0, 1, (4, 64, 48, 17)).astype(np.float32)
    tgt = rng.uniform(0, 1, (4, 64, 48, 17)).astype(np.float32)
    w = rng.uniform(0, 1, (4, 17)).astype(np.float32)
    np.testing.assert_allclose(
        float(ttrain.keypoint_mse_loss(*map(torch.from_numpy, (pred, tgt, w)))),
        float(jtrain.keypoint_mse_loss(*map(jnp.asarray, (pred, tgt, w)))),
        rtol=1e-6)
    logits = rng.normal(0, 3, (9, 6)).astype(np.float32)
    labels = rng.integers(0, 6, 9)
    for cw in (None, jtrain.ID_CLASS_WEIGHTS):
        for smooth in (0.1, 0.0):
            got = ttrain.label_smooth_loss(torch.from_numpy(logits),
                                           torch.from_numpy(labels), cw, smooth)
            want = jtrain.label_smooth_loss(jnp.asarray(logits),
                                            jnp.asarray(labels), cw, smooth)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert ttrain.ID_CLASS_WEIGHTS == jtrain.ID_CLASS_WEIGHTS


@pytest.mark.parametrize("kw", [
    dict(),
    dict(base_lr=2e-3, warmup_steps=5),
    dict(warmup_steps=0, milestones_steps=(3, 7), gamma=0.5),
    dict(base_lr=1e-3, warmup_steps=100, warmup_factor=0.01,
         milestones_steps=(50, 150, 300)),
])
def test_pose_lr_schedule_matches_jax(kw):
    js, ts = jtrain.pose_lr_schedule(**kw), ttrain.pose_lr_schedule(**kw)
    for step in (0, 1, 2, 3, 4, 5, 6, 7, 8, 49, 50, 99, 100, 150, 299, 300,
                 499, 500, 501, 10000):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-12,
                                   atol=0, err_msg=f"step {step}")


# ---------------------------------------------------- layer ids, decay sets

def _tiny_vit_variables(depth=3):
    cfg = dict(TINY_VIT, depth=depth, deconv_channels=(8,))
    jm = jnn.ViTPose(jnn.VitPoseConfig(**cfg))
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 48, 3)))
    return cfg, jax.tree_util.tree_map(np.asarray, v)


def _as_port_names(variables, leaf_fn):
    """A value per JAX parameter path, filled over its leaf and carried to
    the port's state-dict names by vitpose_from_jax."""
    tree = jax.tree_util.tree_map_with_path(
        lambda p, x: np.full(x.shape, float(leaf_fn(p)), np.float32),
        variables["params"])
    sd = vitpose_from_jax({"params": tree,
                           "batch_stats": variables["batch_stats"]})
    return {k: v.flatten()[0].item() for k, v in sd.items()
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))}


def test_layer_ids_and_decay_sets_match_jax():
    cfg, variables = _tiny_vit_variables()
    tm = tnn.ViTPose(tnn.VitPoseConfig(**cfg), device="cpu")
    params = dict(tm.named_parameters())
    want_ids = _as_port_names(variables,
                              lambda p: jtrain._pose_layer_id(p, 3))
    want_nd = _as_port_names(variables, jtrain._no_decay)
    assert set(want_ids) == set(params)
    for k, p in params.items():
        assert ttrain._pose_layer_id(k, 3) == want_ids[k], k
        assert ttrain._no_decay(k, p) == bool(want_nd[k]), k
    assert ttrain._pose_layer_id("backbone.layers.2.ffn.layers.1.weight", 3) == 3
    assert ttrain._pose_layer_id("backbone.ln1.weight", 3) == 4
    assert ttrain._no_decay("head.deconv_layers.1.weight",
                            params["head.deconv_layers.1.weight"])


@pytest.mark.parametrize("scale", [1.0, 1e-4], ids=["clipped", "unclipped"])
def test_pose_optimizer_update_matches_optax(scale):
    """Two updates of make_pose_optimizer against the optax chain, with
    gradients whose global norm is above the clip (clipped) or below it."""
    cfg, variables = _tiny_vit_variables()
    rng = np.random.default_rng(3)
    grads = jax.tree_util.tree_map(
        lambda x: (rng.normal(0, 1, x.shape) * scale).astype(np.float32),
        variables["params"])
    sched = dict(base_lr=2e-3, warmup_steps=5)
    jopt = jtrain.make_pose_optimizer(
        variables["params"], schedule=jtrain.pose_lr_schedule(**sched),
        num_layers=3)
    conv = lambda tree: {  # noqa: E731
        k: v for k, v in vitpose_from_jax(
            {"params": tree, "batch_stats": variables["batch_stats"]}).items()
        if not k.endswith(("running_mean", "running_var",
                           "num_batches_tracked"))}
    params, tgrads = conv(variables["params"]), conv(grads)
    topt = ttrain.make_pose_optimizer(
        params, schedule=ttrain.pose_lr_schedule(**sched), num_layers=3)
    jstate, tstate = jopt.init(variables["params"]), topt.init(params)
    jp = variables["params"]
    for _ in range(2):
        ju, jstate = jopt.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = topt.update(tgrads, tstate, params)
        params = optim.apply_updates(params, tu)
        want = conv(ju)
        for k, u in tu.items():
            np.testing.assert_allclose(u.numpy(), want[k].numpy(), rtol=1e-6,
                                       atol=1e-9, err_msg=k)
    for k, p in conv(jp).items():
        np.testing.assert_allclose(params[k].numpy(), p.numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=k)


def test_adamw_and_adam_match_optax():
    rng = np.random.default_rng(4)
    p = {"a.weight": rng.normal(0, 1, (5, 3)).astype(np.float32),
         "a.bias": rng.normal(0, 1, 5).astype(np.float32)}
    mask = {"a.weight": True, "a.bias": False}
    for jopt, topt in (
            (optax.adamw(1e-2, weight_decay=0.05, mask=mask),
             optim.adamw(1e-2, weight_decay=0.05, mask=mask)),
            (optax.adam(1e-2), optim.adam(1e-2)),
            (optax.sgd(0.3), optim.scale_by_learning_rate(0.3))):
        jp, tp = dict(p), {k: torch.from_numpy(v) for k, v in p.items()}
        js, ts = jopt.init(jp), topt.init(tp)
        for _ in range(3):
            g = {k: rng.normal(0, 1, v.shape).astype(np.float32)
                 for k, v in p.items()}
            ju, js = jopt.update(g, js, jp)
            jp = optax.apply_updates(jp, ju)
            tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                                 ts, tp)
            tp = optim.apply_updates(tp, tu)
        for k in p:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-9)


# ------------------------------------------------------------ training mode

def test_make_trainable_float32_params_and_flax_batchnorm():
    """A bf16 model made trainable keeps float32 parameters, computes in
    bf16, and its BatchNorm normalizes with the batch's biased variance
    and moves the running statistics by 0.9 / 0.1 (Flax's)."""
    torch.manual_seed(0)
    m = torch.nn.Sequential(Linear(4, 6, dtype=torch.bfloat16))
    make_trainable(m)
    assert m[0].weight.dtype == torch.float32 and m[0].weight.requires_grad
    assert m(torch.randn(3, 4)).dtype == torch.bfloat16

    bn = BatchNorm2d(3)
    with torch.no_grad():
        bn.running_mean.fill_(0.5)
        bn.running_var.fill_(2.0)
        bn.weight.copy_(torch.tensor([1.0, 2.0, 0.5]))
        bn.bias.copy_(torch.tensor([0.0, 1.0, -1.0]))
    make_trainable(bn)
    x = torch.randn(4, 3, 5, 5, dtype=torch.float64).float()
    y = bn(x)
    mean = x.double().mean((0, 2, 3))
    var = x.double().var((0, 2, 3), unbiased=False)
    w, b = bn.weight.detach().double(), bn.bias.detach().double()
    want = ((x.double() - mean[:, None, None])
            / torch.sqrt(var[:, None, None] + 1e-5)
            * w[:, None, None] + b[:, None, None])
    np.testing.assert_allclose(y.detach().numpy(), want.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               (0.9 * 0.5 + 0.1 * mean).numpy(), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               (0.9 * 2.0 + 0.1 * var).numpy(), atol=1e-6)
    bn.eval()
    want = ((x.double() - bn.running_mean.double()[:, None, None])
            / torch.sqrt(bn.running_var.double()[:, None, None] + 1e-5)
            * w[:, None, None] + b[:, None, None])
    np.testing.assert_allclose(bn(x).detach().numpy(), want.numpy(), atol=1e-5)


def test_make_trainable_refuses_int8():
    m = tnn.ViTPose(tnn.VitPoseConfig(**TINY_VIT, quantize="int8"),
                    device="cpu")
    with pytest.raises(ValueError, match="int8"):
        make_trainable(m)


# ----------------------------------------------------------------- the steps

def test_pose_train_steps_match_jax():
    """3 steps of test_train.py's tiny ViT (64x48, embed 32, depth 2) with
    the layer-decay AdamW and a 5-step warmup."""
    jm = jnn.ViTPose(jnn.VitPoseConfig(**TINY_VIT))
    rng = np.random.default_rng(1)
    crops = rng.normal(0, 1, (4, 64, 48, 3)).astype(np.float32)
    kps = rng.uniform(8, 40, (4, 17, 2)).astype(np.float32)
    vis = np.ones((4, 17), np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(crops))
    jp, jbs = variables["params"], {"batch_stats": variables["batch_stats"]}
    jopt = jtrain.make_pose_optimizer(
        jp, schedule=jtrain.pose_lr_schedule(base_lr=2e-3, warmup_steps=5),
        num_layers=2)
    jstate = jopt.init(jp)
    jstep = jtrain.make_pose_train_step(jm, jopt)

    tm = tnn.ViTPose(tnn.VitPoseConfig(**TINY_VIT), device="cpu")
    tm.load_state_dict(vitpose_from_jax(variables))
    tp, tbs = ttrain.train_state(tm)
    topt = ttrain.make_pose_optimizer(
        tp, schedule=ttrain.pose_lr_schedule(base_lr=2e-3, warmup_steps=5),
        num_layers=2)
    tstate = topt.init(tp)
    tstep = ttrain.make_pose_train_step(tm, topt)
    tin = [torch.from_numpy(a) for a in (crops, kps, vis)]
    for _ in range(3):
        jp, jbs, jstate, jl = jstep(jp, jbs, jstate, *map(jnp.asarray,
                                                           (crops, kps, vis)))
        tp, tbs, tstate, tl = tstep(tp, tbs, tstate, *tin)
        np.testing.assert_allclose(float(tl), float(jl), rtol=2e-6)
    want = vitpose_from_jax({"params": jp, **jbs})
    C = TINY_VIT["embed_dim"]
    for k, v in tp.items():
        got, ref = v.numpy(), want[k].numpy()
        if k.endswith("qkv.bias"):
            np.testing.assert_allclose(got[C:2 * C], ref[C:2 * C], atol=1e-4)
            got, ref = np.delete(got, np.s_[C:2 * C]), np.delete(ref, np.s_[C:2 * C])
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-6, err_msg=k)
    assert len(tbs) == 4
    for k, v in tbs.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_id_train_steps_match_jax():
    """3 ID steps on a ResNet-50 at 32x32 (batch 6, the reference class
    weights, label smoothing 0.1), plain SGD at 1e-2 from the
    zero-residual-scale init (see the module docstring)."""
    jm = jnn.ResNetClassifier(jnn.ResNetConfig(depth=50))
    rng = np.random.default_rng(2)
    imgs = rng.normal(0, 1, (6, 32, 32, 3)).astype(np.float32)
    labels = np.arange(6) % 6
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(imgs))
    jp = {k: ({**v, "bn3": {**v["bn3"],
                            "scale": jnp.zeros_like(v["bn3"]["scale"])}}
              if k.startswith("layer") else v)
          for k, v in variables["params"].items()}
    jbs = {"batch_stats": variables["batch_stats"]}
    jopt = optax.sgd(1e-2)
    jstate = jopt.init(jp)
    jstep = jtrain.make_id_train_step(jm, jopt)

    tm = tnn.ResNetClassifier(tnn.ResNetConfig(depth=50), device="cpu")
    tm.load_state_dict(resnet_from_jax({"params": jp, **jbs}))
    tp, tbs = ttrain.train_state(tm)
    topt = optim.scale_by_learning_rate(1e-2)
    tstate = topt.init(tp)
    tstep = ttrain.make_id_train_step(tm, topt)
    losses = []
    for _ in range(3):
        jp, jbs, jstate, jl = jstep(jp, jbs, jstate, jnp.asarray(imgs),
                                    jnp.asarray(labels))
        tp, tbs, tstate, tl = tstep(tp, tbs, tstate, torch.from_numpy(imgs),
                                    torch.from_numpy(labels))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        losses.append(float(tl))
    assert losses[-1] < losses[0]
    want = resnet_from_jax({"params": jp, **jbs})
    for k, v in tp.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=3e-5, err_msg=k)
    for k, v in tbs.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)

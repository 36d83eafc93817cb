"""ViTDet-H in the port (``nn/vitdet.py``, ``nn/vit.py``'s window and
rel-pos options, ``nn/attention.py::relpos_attention_reference``, the
square input) against the benchmark's plain float32 reference
(``portbench/reference/vitdet.py``, imported by path), on the CPU at a tiny
width: seeded weights of the benchmark's ``vitdet`` configuration cut by
its architecture file's ``tiny`` (a 4 x 4 map in 3 x 3 windows, so the
window blocks pad it to 6 x 6; blocks 1 and 3 global), and the input
geometry the perception reads from the detector.

Tolerances: both sides compute in float32, take their LayerNorms from
``F.layer_norm`` and differ only in the order of sums (batched against
blocked attention, einsum against products), a few float32 ulps a layer:
1e-5 of a tensor's range for one block or the attention, 1e-4 for the
pyramid and the whole detector (more layers, sums over up to 1,280
channels). The rel-pos terms and the padded tokens' keys move the
outputs by far more than that (held below)."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import files  # noqa: E402
from portbench.reference import detect  # noqa: E402
from portbench.weights import seeded_state  # noqa: E402

from macaque_tpu_torch.nn.attention import relpos_attention_reference  # noqa: E402
from macaque_tpu_torch.nn.detector import detect_frames  # noqa: E402
from macaque_tpu_torch.nn.preprocess import detector_input_batch  # noqa: E402
from macaque_tpu_torch.nn.vit import window_partition, window_unpartition  # noqa: E402

SEED = 2 ** 31 + 2027
BLOCK_TOL, NET_TOL = 1e-5, 1e-4


def _reference_module():
    path = os.path.join(ROOT, "portbench", "reference", "vitdet.py")
    spec = importlib.util.spec_from_file_location("reference_vitdet", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_module()


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    return ((got - want).abs().max() / (want.max() - want.min())).item()


@pytest.fixture(scope="module")
def nets():
    """(tiny block, program detector, reference detector, state dict), the
    box head's foreground bias raised by 6 as the ``occupied`` mix does,
    each side loaded as the benchmark loads it (the architecture file
    scales the relative position tables to ``rel_pos_init_std``)."""
    full = files.load_json("configs/vitdet.json")["networks"]["detector"]
    arch = files.arch(full)
    c = arch.tiny(full)
    sd = seeded_state("detector", c, SEED, "cpu")
    sd[arch.FG_BIAS][0] += 6.0
    prog = arch.program(c, torch.float32, "cpu")
    prog.load_state_dict(sd)
    arch.loaded(prog, c, sd)
    ref = arch.reference(c)
    ref.load_state_dict(sd)
    p = prog.backbone.layers[0].attn.rel_pos_h
    assert torch.equal(p, ref.backbone.layers[0].attn.rel_pos_h)
    assert 0.7 < p.std().item() / c["rel_pos_init_std"] < 1.3
    return c, prog, ref, sd


def _map(c, seed=0, B=2):
    g = c["img_size"] // c["patch_size"]
    x = np.random.default_rng(seed).normal(size=(B, g, g, c["embed_dim"]))
    return torch.from_numpy(x).float()


@pytest.mark.parametrize("kind", ["window", "global"])
def test_block_matches_the_reference(nets, kind):
    c, prog, ref, _ = nets
    i = c["global_blocks"][0] if kind == "global" else 0
    pb, rb = prog.backbone.layers[i], ref.backbone.layers[i]
    assert (pb.window, pb.attn.rel_pos) == ((0, (4, 4)) if kind == "global"
                                            else (3, (3, 3)))
    x = _map(c)
    with torch.no_grad():
        assert _rel(pb(x), rb(x)) < BLOCK_TOL


def test_window_padding_is_a_reshape_round_trip():
    x = torch.arange(2 * 4 * 5 * 3, dtype=torch.float32).reshape(2, 4, 5, 3)
    win, padded = window_partition(x, 3)
    assert padded == (6, 6) and win.shape == (2 * 4, 3, 3, 3)
    assert (win[1, :, 2] == 0).all() and (win[3, 1:] == 0).all()
    assert torch.equal(window_unpartition(win, 3, padded, (4, 5)), x)


def _masked_window_block(rb, x):
    """The reference's window block with the padded tokens masked out as
    keys: what an implementation that masked them would compute."""
    B, H, W, C = x.shape
    w, a = rb.window, rb.attn
    y, (Hp, Wp) = window_partition(rb.ln1(x), w)
    valid = torch.zeros(B, Hp, Wp)
    valid[:, :H, :W] = 1
    valid, _ = window_partition(valid[..., None], w)
    n, hd, T = a.heads, C // a.heads, w * w
    q, k, v = a.qkv(y.reshape(-1, T, C)).reshape(-1, T, 3, n, hd).permute(2, 0, 3, 1, 4)
    s = (q * hd ** -0.5) @ k.transpose(-2, -1)
    Rh, Rw = REF.rel_pos(a.rel_pos_h, w), REF.rel_pos(a.rel_pos_w, w)
    r_q = q.reshape(-1, n, w, w, hd)
    s = (s.view(-1, n, w, w, w, w)
         + torch.einsum("bnhwc,hkc->bnhwk", r_q, Rh)[..., :, None]
         + torch.einsum("bnhwc,wkc->bnhwk", r_q, Rw)[..., None, :]).view(-1, n, T, T)
    s = s.masked_fill(valid.reshape(-1, 1, 1, T) == 0, -torch.inf)
    o = a.proj((torch.softmax(s, -1) @ v).transpose(1, 2).reshape(-1, w, w, C))
    x = x + window_unpartition(o, w, (Hp, Wp), (H, W))
    f = rb.ffn.layers
    return x + f[1](torch.nn.functional.gelu(f[0](rb.ln2(x))))


def test_zeroed_rel_pos_or_masked_padding_would_be_seen(nets):
    """Both choices the block makes move its output far beyond the
    tolerance: zeroing the relative position tables, and masking the
    padded tokens (the published block does not)."""
    c, prog, ref, _ = nets
    pb, rb = prog.backbone.layers[0], ref.backbone.layers[0]
    x = _map(c, seed=1)
    with torch.no_grad():
        want = rb(x)
        assert _rel(_masked_window_block(rb, x), want) > 100 * BLOCK_TOL
        saved = pb.attn.rel_pos_h.clone(), pb.attn.rel_pos_w.clone()
        pb.attn.rel_pos_h.zero_()
        pb.attn.rel_pos_w.zero_()
        try:
            assert _rel(pb(x), want) > 100 * BLOCK_TOL
        finally:
            pb.attn.rel_pos_h.copy_(saved[0])
            pb.attn.rel_pos_w.copy_(saved[1])
        assert _rel(pb(x), want) < BLOCK_TOL


def test_pyramid_matches_the_reference(nets):
    c, prog, ref, _ = nets
    x = _map(c, seed=2)
    with torch.no_grad():
        got, want = prog.neck(x), ref.neck(x)
    g = c["img_size"] // c["patch_size"]
    assert [m.shape[1] for m in got] == [4 * g, 2 * g, g, g // 2, g // 4]
    assert all(m.shape[-1] == c["fpn_channels"] for m in got)
    for p, r in zip(got, want):
        assert _rel(p, r) < NET_TOL


def _plain_relpos(qkv, rel_h, rel_w, heads):
    """The equations, written out: S = q k^T / sqrt(d) + rel_h[q, k_h] +
    rel_w[q, k_w], P = softmax(S), O = P V."""
    B, T, C3 = qkv.shape
    d = C3 // 3 // heads
    g = rel_h.shape[-1]
    q, k, v = qkv.reshape(B, T, 3, heads, d).permute(2, 0, 3, 1, 4)
    kh = torch.arange(T) // g
    kw = torch.arange(T) % g
    bias = rel_h[..., kh] + rel_w[..., kw]              # (B, heads, T, T)
    p = torch.softmax(q @ k.transpose(-1, -2) / d ** 0.5 + bias, -1)
    return (p @ v).transpose(1, 2).reshape(B, T, heads * d)


@pytest.mark.parametrize("B, heads, g", [(3, 2, 14), (1, 1, 64)])
def test_relpos_attention_reference_is_the_equations(B, heads, g):
    rng = np.random.default_rng(g)
    T, d = g * g, 16
    qkv = torch.from_numpy(rng.normal(size=(B, T, 3 * heads * d))).float()
    rel_h, rel_w = (torch.from_numpy(rng.normal(size=(B, heads, T, g)) * 0.5).float()
                    for _ in range(2))
    got = relpos_attention_reference(qkv, rel_h, rel_w, heads)
    assert _rel(got, _plain_relpos(qkv, rel_h, rel_w, heads)) < BLOCK_TOL


def test_square_input_pads_the_resized_frame_with_zeros(nets):
    c = nets[0]
    arch = files.arch(c)
    rgb = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 48, 96, 3)).astype(np.float32))
    got, scale, (h, w) = detector_input_batch(rgb, c["img_size"],
                                              square=c["img_size"])
    want, want_scale = arch.reference_input(rgb, c)
    assert got.shape == want.shape == (2, 64, 64, 3)
    assert (h, w) == (32, 64) and scale == want_scale == 64 / 96
    assert (got[:, h:] == 0).all() and (got[:, :h].abs().sum((1, 2, 3)) > 0).all()
    assert _rel(got, want) < BLOCK_TOL
    with pytest.raises(ValueError, match="square"):
        detector_input_batch(rgb, 128, square=64)


def test_detector_matches_the_reference_through_detect_frames(nets):
    """Maps and RPN outputs against the reference's; the proposals, the box
    head and the NMS of ``detect_frames`` against ``reference/detect.py``
    run on the program's own maps and RPN outputs, as the benchmark's
    check runs them."""
    c, prog, ref, _ = nets
    rgb = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 48, 96, 3)).astype(np.float32))
    x, _, _ = detector_input_batch(rgb, c["img_size"], square=c["img_size"])
    with torch.no_grad():
        maps, rpn = prog.trunk(x)
        boxes, scores, valid = detect_frames(prog, x)
        for f in range(len(x)):
            rmaps = ref.maps(x[f:f + 1])
            assert max(_rel(p[f:f + 1], r) for p, r in zip(maps, rmaps)) < NET_TOL
            rrpn = ref.rpn_head([m[f:f + 1] for m in maps])
            assert max(_rel(p[f:f + 1], r) for pr, rr in zip(rpn, rrpn)
                       for p, r in zip(pr, rr)) < NET_TOL
            props = detect.proposals([(cl[f], rg[f]) for cl, rg in rpn], c,
                                     tuple(x.shape[1:3]))
            rb, rs = detect.head(ref.roi_head.bbox_head, [m[f] for m in maps[:4]],
                                 props[:c["rcnn_roi_topk"]], tuple(x.shape[1:3]))
            kb, ks, _ = detect.detections(rb, rs, c, c["rcnn_max"])
            k = int(valid[f].sum())
            assert k == len(ks) > 0
            order = torch.argsort(scores[f][valid[f]], descending=True)
            got_b = boxes[f][valid[f]][order].double().numpy()
            got_s = scores[f][valid[f]][order].double().numpy()
            assert np.abs(got_s - ks).max() < 1e-5
            assert np.abs(got_b - kb).max() < 1e-3       # pixels of 64


def _tiny_swin():
    """The parity configuration's Swin-S detector at its tiny cut, loaded
    as the ``nets`` fixture loads ViTDet."""
    full = files.load_json("configs/parity.json")["networks"]["detector"]
    arch = files.arch(full)
    c = arch.tiny(full)
    sd = seeded_state("detector", c, SEED, "cpu")
    sd[arch.FG_BIAS][0] += 6.0
    det = arch.program(c, torch.float32, "cpu")
    det.load_state_dict(sd)
    return det


@pytest.mark.parametrize("kind", ["swin", "vitdet"])
def test_the_perception_takes_the_detectors_input_geometry(nets, monkeypatch,
                                                           kind):
    """ViTDet states its square input (``square``, its ``img_size``):
    ``TorchPerception`` resizes each frame keeping its ratio to fit that
    square, whatever ``det_target`` says, and pads to it. Swin-S states
    none and keeps the keep-ratio target, padded to /32."""
    from macaque_tpu_torch.pipeline import perception

    det = nets[1] if kind == "vitdet" else _tiny_swin()
    assert det.square == (64 if kind == "vitdet" else None)
    p = perception.TorchPerception(det, torch.nn.Identity(),
                                   torch.nn.Identity(), det_target=800
                                   if kind == "vitdet" else 64, device="cpu")
    assert (p.det_target, p.det_square) == ((64, 64) if kind == "vitdet"
                                            else (64, None))
    seen = []
    real = perception.detect_frames
    monkeypatch.setattr(perception, "detect_frames",
                        lambda m, x: seen.append(tuple(x.shape)) or real(m, x))
    frames = np.random.default_rng(5).integers(0, 256, (2, 48, 96, 3),
                                               dtype=np.uint8)
    boxes, valid = p.detect(frames)[:2]
    assert seen == [(2, 64, 64, 3) if kind == "vitdet" else (2, 32, 64, 3)]
    assert valid.any()


def test_build_detector_refuses_an_unknown_kind():
    from macaque_tpu_torch.pipeline.weights import build_detector

    with pytest.raises(ValueError, match="no detector"):
        build_detector("detr", "cpu")

"""The port's checkpoints (``macaque_tpu_torch/nn/checkpoint.py``): state
dicts and optimizer states through ``save_params``/``load_params`` and
back, equal bit for bit, and ``convert_and_cache`` converting a ``.pth``
once."""

import os

import numpy as np
import pytest
import torch

from macaque_tpu_torch import nn as tnn
from macaque_tpu_torch.nn import optim
from macaque_tpu_torch.nn import train as ttrain
from macaque_tpu_torch.nn.checkpoint import (
    convert_and_cache, load_params, save_params)

TINY_VIT = dict(img_size=(64, 48), embed_dim=32, depth=2, num_heads=2,
                deconv_channels=(8, 8))


def _model(seed):
    torch.manual_seed(seed)
    return tnn.ViTPose(tnn.VitPoseConfig(**TINY_VIT), device="cpu")


def test_state_dict_and_optimizer_round_trip(tmp_path):
    model = _model(0)
    params, stats = ttrain.train_state(model)
    opt = ttrain.make_pose_optimizer(params, num_layers=2)
    state = opt.init(params)
    step = ttrain.make_pose_train_step(model, opt)
    rng = np.random.default_rng(0)
    batch = (torch.from_numpy(rng.normal(0, 1, (2, 64, 48, 3)).astype(np.float32)),
             torch.from_numpy(rng.uniform(8, 40, (2, 17, 2)).astype(np.float32)),
             torch.ones(2, 17))
    params, stats, state, _ = step(params, stats, state, *batch)
    path = save_params(str(tmp_path / "ckpt" / "step1.pt"),
                       {"params": params, "batch_stats": stats,
                        "opt_state": state})
    assert os.path.isabs(path) and os.path.exists(path)
    back = load_params(path)
    for k, v in params.items():
        assert torch.equal(back["params"][k], v)
    for k, v in stats.items():
        assert torch.equal(back["batch_stats"][k], v)
    assert back["opt_state"][1]["count"] == 1
    for k, v in state[1]["mu"].items():
        assert torch.equal(back["opt_state"][1]["mu"][k], v)
    # the restored state takes the next step exactly as the original
    a = step(params, stats, state, *batch)
    b = step(back["params"], back["batch_stats"], back["opt_state"], *batch)
    assert torch.equal(a[3], b[3])
    for k in params:
        assert torch.equal(a[0][k], b[0][k])


def test_load_into_a_module_and_a_template(tmp_path):
    src, dst = _model(1), _model(2)
    path = save_params(str(tmp_path / "vit.pt"), src.state_dict())
    assert load_params(path, like=dst) is dst
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v)
    like = {k: v.to(torch.float64) for k, v in src.state_dict().items()
            if v.is_floating_point()}
    with pytest.raises(KeyError):
        load_params(path, like=like)
    path2 = save_params(str(tmp_path / "f.pt"),
                        {k: src.state_dict()[k] for k in like})
    got = load_params(path2, like=like)
    assert all(v.dtype == torch.float64 for v in got.values())


def test_convert_and_cache_converts_once(tmp_path):
    pth = tmp_path / "pose.pth"
    torch.save({"state_dict": _model(3).state_dict()}, pth)
    calls = []

    def converter(sd):
        calls.append(1)
        return {k: v * 2 for k, v in sd.items() if v.is_floating_point()}

    a = convert_and_cache(str(pth), converter, str(tmp_path / "cache"))
    b = convert_and_cache(str(pth), converter, str(tmp_path / "cache"))
    assert len(calls) == 1
    assert os.path.exists(tmp_path / "cache" / "pose.pt")
    for k in a:
        assert torch.equal(a[k], b[k])


def test_optimizer_state_of_a_chain_saves(tmp_path):
    p = {"w": torch.randn(3, 2)}
    opt = optim.adamw(1e-2)
    s = opt.init(p)
    _, s = opt.update({"w": torch.ones(3, 2)}, s, p)
    back = load_params(save_params(str(tmp_path / "s.pt"), s))
    assert back[0]["count"] == 1 and torch.equal(back[0]["nu"]["w"], s[0]["nu"]["w"])

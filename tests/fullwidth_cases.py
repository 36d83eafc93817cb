"""Stage 1's three networks at full width, shared by the
``tests/test_torch_fullwidth_*.py`` files: every width of the configurations
the card runs (``VitPoseConfig()``, ``DetectorConfig()`` with Swin-S,
``DetectorConfig.serving()``, ResNet-152) with only the depth cut, one
mm-keyed state dict a network drawn with numpy, loaded into the JAX package
through its ``nn/convert.py`` converters and into the port through
``pipeline/weights.py::load_checkpoint``, and 2048x1536 frames.

Both sides compute in float32: the JAX package with x64 off, as it runs in
production, and the port with its TF32 switches off (``tf32_off``, which
the test files take as an autouse fixture: the CPU ignores the switches,
the card would not)."""

import contextlib
import dataclasses
import io
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macaque_tpu import nn as jnn
from macaque_tpu.nn.convert import (
    convert_resnet, convert_swin_maskrcnn, convert_vitpose)
from macaque_tpu.nn.swin import SwinConfig as JSwinConfig
from macaque_tpu_torch import nn as tnn
from macaque_tpu_torch.nn.swin import SwinConfig as TSwinConfig
from macaque_tpu_torch.pipeline.weights import load_checkpoint

VIT_DEPTH = 2                       # of ViTPose-huge's 32
SWIN_DEPTHS = (2, 2, 2, 2)          # of Swin-S's (2, 2, 18, 2)
RESNET_BLOCKS = (1, 1, 1, 1)        # of ResNet-152's (3, 8, 36, 3)
FRAME_HW = (1536, 2048)
# random box-head weights score nothing near the pipeline's 0.85 threshold:
# a raised foreground bias (chip_smoke.py's) lets detections through, so
# pose and ID run; the scores still vary with the RoI features
FG_BIAS = 6.0

# the widths the card runs, written out: test_torch_fullwidth_weights.py
# holds both packages' defaults to them
VIT_WIDTHS = dict(img_size=(256, 192), patch_size=16, patch_padding=2,
                  embed_dim=1280, num_heads=16, mlp_ratio=4.0,
                  num_keypoints=17, deconv_channels=(256, 256))
SWIN_WIDTHS = dict(embed_dim=96, num_heads=(3, 6, 12, 24), window=7,
                   mlp_ratio=4.0, patch_size=4)
DET_WIDTHS = dict(fpn_channels=256, num_classes=1, rpn_nms_pre=1000,
                  rpn_max=1000, rcnn_max=100, rcnn_roi_topk=1000,
                  rcnn_roi_chunk=256, strides=(4, 8, 16, 32, 64))
SERVING_WIDTHS = dict(DET_WIDTHS, rpn_nms_pre=512, rpn_max=512,
                      rcnn_roi_topk=128, rcnn_roi_chunk=64)
RESNET_WIDTHS = dict(depth=152, num_classes=6)


@pytest.fixture(autouse=True, scope="module")
def tf32_off():
    """float32 products and convolutions in full float32 on a card too
    (cuDNN's convolutions take TF32 by default): both TF32 switches off,
    restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@dataclass(frozen=True)
class JCutResNet(jnn.ResNetConfig):
    @property
    def stage_blocks(self):
        return RESNET_BLOCKS


@dataclass(frozen=True)
class TCutResNet(tnn.ResNetConfig):
    @property
    def stage_blocks(self):
        return RESNET_BLOCKS


def vit_configs(**kw):
    """(JAX, port) ``VitPoseConfig()`` at depth VIT_DEPTH."""
    return (dataclasses.replace(jnn.VitPoseConfig(), depth=VIT_DEPTH, **kw),
            dataclasses.replace(tnn.VitPoseConfig(), depth=VIT_DEPTH, **kw))


def det_configs(serving=False):
    """(JAX, port) ``DetectorConfig()`` (or ``.serving()``) on Swin-S at
    depths SWIN_DEPTHS."""
    out = []
    for pkg, swin in ((jnn, JSwinConfig), (tnn, TSwinConfig)):
        make = pkg.DetectorConfig.serving if serving else pkg.DetectorConfig
        out.append(make(swin=dataclasses.replace(swin(), depths=SWIN_DEPTHS)))
    return tuple(out)


def draw_state_dict(model, seed):
    """numpy arrays under the keys and shapes of the port's ``model`` (its
    mm names): weights of rank >= 2 N(0, 1/fan_in), norm scales
    1 + N(0, 0.05), BatchNorm means N(0, 0.1) and variances U(0.5, 1.5),
    biases, tables and position embeddings N(0, 0.02)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if not v.dtype.is_floating_point:
            sd[k] = np.zeros(shape, np.int64)
            continue
        if k.endswith("running_mean"):
            a = rng.normal(0, 0.1, shape)
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith(".weight") and len(shape) >= 2:
            a = rng.normal(0, 1 / np.sqrt(np.prod(shape[1:])), shape)
        elif k.endswith(".weight"):
            a = 1 + rng.normal(0, 0.05, shape)
        else:
            a = rng.normal(0, 0.02, shape)
        sd[k] = a.astype(np.float32)
    return sd


def _quiet(fn, *args):
    """``fn(*args)`` and what it printed (both loaders print the checkpoint
    keys they did not consume)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


@dataclass
class Network:
    """One network in both packages from one state dict: ``jax_model``,
    ``jax_vars`` (through the converter), ``port`` (through
    ``load_checkpoint``), the numpy ``state_dict`` and what each loader
    printed."""
    jax_model: object
    jax_vars: dict
    port: torch.nn.Module
    state_dict: dict
    printed: tuple


def load_both(jax_model, port, sd, convert):
    jvars, jprint = _quiet(convert, sd)
    jvars = jax.tree.map(jnp.asarray, jvars)
    ckpt = {"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}
    _, tprint = _quiet(load_checkpoint, port, "checkpoint", ckpt)
    return Network(jax_model, jvars, port, sd, (jprint, tprint))


def detector(seed=20):
    jcfg, tcfg = det_configs()
    sd = draw_state_dict(tnn.SwinMaskRCNN(tcfg, device="meta"), seed)
    sd["roi_head.bbox_head.fc_cls.bias"][0] += FG_BIAS
    return load_both(jnn.SwinMaskRCNN(jcfg),
                     tnn.SwinMaskRCNN(tcfg, device="cpu"), sd,
                     lambda s: convert_swin_maskrcnn(s, depths=SWIN_DEPTHS))


def vitpose(seed=21):
    jcfg, tcfg = vit_configs()
    sd = draw_state_dict(tnn.ViTPose(tcfg, device="meta"), seed)
    return load_both(jnn.ViTPose(jcfg), tnn.ViTPose(tcfg, device="cpu"), sd,
                     lambda s: convert_vitpose(s, depth=VIT_DEPTH))


def resnet(seed=22):
    sd = draw_state_dict(tnn.ResNetClassifier(TCutResNet(), device="meta"),
                         seed)
    return load_both(jnn.ResNetClassifier(JCutResNet()),
                     tnn.ResNetClassifier(TCutResNet(), device="cpu"), sd,
                     lambda s: convert_resnet(s, stage_blocks=RESNET_BLOCKS))


def synthetic_frames(n, seed=0, hw=FRAME_HW):
    """BGR uint8 frames: a blocky textured cage with four bright blobs
    drifting a few pixels a frame (chip_smoke.py's scene)."""
    rng = np.random.default_rng(seed)
    H, W = hw
    base = np.kron(rng.integers(40, 200, (H // 32, W // 32, 3), dtype=np.uint8),
                   np.ones((32, 32, 1), np.uint8))
    yy, xx = np.mgrid[0:H, 0:W]
    blobs = [(rng.uniform(0.2, 0.8) * H, rng.uniform(0.2, 0.8) * W,
              rng.uniform(0.08, 0.17) * H, rng.uniform(0.04, 0.1) * W)
             for _ in range(4)]
    frames = np.empty((n, H, W, 3), np.uint8)
    for t in range(n):
        f = base.copy()
        for k, (cy, cx, ry, rx) in enumerate(blobs):
            cy, cx = cy + 3 * t * np.sin(k), cx + 4 * t * np.cos(k)
            m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
            f[m] = (230 - 40 * k, 180, 60 + 40 * k)
        frames[t] = f
    return frames

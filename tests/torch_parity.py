"""Shared pieces of the parity tests between ``macaque_tpu`` (JAX) and
``macaque_tpu_torch``: small model configurations for both packages and
random Flax variables drawn with numpy (shapes from ``jax.eval_shape``, so
no init program is compiled), handed to the port through
``macaque_tpu_torch.nn.convert``."""

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from macaque_tpu import nn as jnn
from macaque_tpu.nn.swin import SwinConfig as JSwinConfig
from macaque_tpu_torch import nn as tnn
from macaque_tpu_torch.nn.swin import SwinConfig as TSwinConfig

VIT = dict(img_size=(64, 48), embed_dim=64, depth=2, num_heads=4,
           deconv_channels=(32, 32))
SWIN = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 4, 4, 8))
DET = dict(fpn_channels=32, rpn_nms_pre=50, rpn_max=50, rcnn_max=10,
           rcnn_roi_topk=50, rcnn_roi_chunk=16)


@dataclass(frozen=True)
class JTinyResNet(jnn.ResNetConfig):
    @property
    def stage_blocks(self):
        return (2, 2)


@dataclass(frozen=True)
class TTinyResNet(tnn.ResNetConfig):
    @property
    def stage_blocks(self):
        return (2, 2)


def random_variables(model, *inputs, seed=0):
    """Flax variables for ``model`` drawn with numpy: kernels N(0, 1/fan_in),
    biases and tables N(0, 0.02), norm scales 1 + N(0, 0.05), BatchNorm
    means N(0, 0.1) and variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *inputs)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "'kernel'" in name:
            v = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif "'scale'" in name:
            v = 1 + rng.normal(0, 0.05, shape)
        elif "'mean'" in name:
            v = rng.normal(0, 0.1, shape)
        elif "'var'" in name:
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.normal(0, 0.02, shape)
        return jnp.asarray(v.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_detector(**kw):
    return jnn.SwinMaskRCNN(jnn.DetectorConfig(swin=JSwinConfig(**SWIN),
                                               **{**DET, **kw}))


def torch_detector(**kw):
    return tnn.SwinMaskRCNN(tnn.DetectorConfig(swin=TSwinConfig(**SWIN),
                                               **{**DET, **kw}), device="cpu")


def load(model, state_dict):
    model.load_state_dict(state_dict, strict=True)
    return model


def tiny_perceptions(dvars, pvars, ivars, max_det, det_target):
    """The JAX package's ``FlaxPerception`` and the port's
    ``TorchPerception`` (CPU, float32) on the same small-width variables:
    the detector of ``SWIN``/``DET``, the ViTPose of ``VIT`` and the
    two-stage ResNet."""
    from macaque_tpu.pipeline.perception import FlaxPerception
    from macaque_tpu_torch.nn.convert import (
        resnet_from_jax, swin_maskrcnn_from_jax, vitpose_from_jax)
    from macaque_tpu_torch.pipeline.perception import TorchPerception

    flax = FlaxPerception(
        jax_detector(), dvars, jnn.ViTPose(jnn.VitPoseConfig(**VIT)), pvars,
        jnn.ResNetClassifier(JTinyResNet()), ivars, max_det=max_det,
        det_target=det_target)
    port = TorchPerception(
        load(torch_detector(), swin_maskrcnn_from_jax(dvars)),
        load(tnn.ViTPose(tnn.VitPoseConfig(**VIT), device="cpu"),
             vitpose_from_jax(pvars)),
        load(tnn.ResNetClassifier(TTinyResNet(), device="cpu"),
             resnet_from_jax(ivars)),
        max_det=max_det, det_target=det_target, device="cpu")
    return flax, port

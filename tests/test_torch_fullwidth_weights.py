"""What the full-width comparisons stand on: the widths they cut from, and
one mm-keyed state dict a network that both packages load whole.

- The configurations are the packages' own defaults, equal between the two
  (``dataclasses.asdict``; ``compute_dtype`` by name, and the JAX package's
  route switches, which the port takes from the tensor's device, at
  "auto"), so the depth-cut networks of tests/fullwidth_cases.py are the
  widths the card runs.
- Each network's state dict, drawn with numpy under the port's mm key
  names, is consumed whole by the JAX package's converter (its coverage
  report prints nothing) and by ``load_checkpoint`` (nothing missing,
  nothing left over); the converted Flax variables have the JAX model's
  own tree and shapes; and the port's carrier (``*_from_jax``) gives the
  same dict back from them, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macaque_tpu import nn as jnn
from macaque_tpu.core import config as jconfig
from macaque_tpu.nn.swin import SwinConfig as JSwinConfig
from macaque_tpu_torch import nn as tnn
from macaque_tpu_torch.core import config as tconfig
from macaque_tpu_torch.nn.convert import (
    resnet_from_jax, swin_maskrcnn_from_jax, vitpose_from_jax)
from macaque_tpu_torch.nn.swin import SwinConfig as TSwinConfig
from tests import fullwidth_cases as fw

PIPELINE_CONFIGS = ["PipelineConfig", "Step1Config", "TrackerConfig",
                    "CrossViewConfig", "CrossFrameConfig",
                    "TriangulationConfig", "FilterConfig"]


@pytest.mark.parametrize("name", PIPELINE_CONFIGS)
def test_pipeline_configs_equal_between_packages(name):
    assert dataclasses.asdict(getattr(tconfig, name)()) == \
        dataclasses.asdict(getattr(jconfig, name)())


DTYPES = {jnp.float32: "float32", jnp.bfloat16: "bfloat16",
          torch.float32: "float32", torch.bfloat16: "bfloat16"}
# the JAX package's route switches at "auto": the Pallas kernel on a TPU,
# XLA elsewhere, as the port takes its kernel on a CUDA tensor and its
# plain version on a CPU one; ``gelu_approx`` None: the dtype picks the
# GELU, as the port's ``_gelu_approx`` does
JAX_ONLY = {"int8_impl": "auto", "roialign_impl": "auto", "gelu_approx": None}


def _meaning(cfg, jax_side):
    out = dataclasses.asdict(cfg)

    def norm(d):
        for k, v in list(d.items()):
            if isinstance(v, dict):
                norm(v)
            elif k == "compute_dtype":
                d[k] = DTYPES[v]
            elif jax_side and k in JAX_ONLY:
                assert v == JAX_ONLY[k], (k, v)
                del d[k]
        return d

    return norm(out)


NETWORK_CONFIGS = {
    "vitpose": (jnn.VitPoseConfig, tnn.VitPoseConfig, fw.VIT_WIDTHS),
    "swin": (JSwinConfig, TSwinConfig, fw.SWIN_WIDTHS),
    "detector": (jnn.DetectorConfig, tnn.DetectorConfig, fw.DET_WIDTHS),
    "serving": (jnn.DetectorConfig.serving, tnn.DetectorConfig.serving,
                fw.SERVING_WIDTHS),
    "resnet": (jnn.ResNetConfig, tnn.ResNetConfig, fw.RESNET_WIDTHS),
}


@pytest.mark.parametrize("name", NETWORK_CONFIGS)
def test_network_configs_equal_between_packages(name):
    """At their defaults, by meaning, and at the widths the full-width
    tests name."""
    jmake, tmake, widths = NETWORK_CONFIGS[name]
    jcfg, tcfg = jmake(), tmake()
    assert _meaning(tcfg, False) == _meaning(jcfg, True)
    for cfg in (jcfg, tcfg):
        assert {k: getattr(cfg, k) for k in widths} == widths


def test_cut_configs_differ_from_the_defaults_in_depth_only():
    jv, tv = fw.vit_configs()
    assert dataclasses.replace(jv, depth=32) == jnn.VitPoseConfig()
    assert dataclasses.replace(tv, depth=32) == tnn.VitPoseConfig()
    for serving in (False, True):
        jd, td = fw.det_configs(serving)
        for cfg, pkg, swin in ((jd, jnn, JSwinConfig), (td, tnn, TSwinConfig)):
            make = pkg.DetectorConfig.serving if serving else pkg.DetectorConfig
            assert cfg.swin.depths == fw.SWIN_DEPTHS
            assert cfg == make(swin=dataclasses.replace(
                swin(), depths=fw.SWIN_DEPTHS))
            assert dataclasses.replace(cfg.swin, depths=(2, 2, 18, 2)) == swin()
    for cfg, default in ((fw.JCutResNet(), jnn.ResNetConfig()),
                         (fw.TCutResNet(), tnn.ResNetConfig())):
        assert cfg.stage_blocks == fw.RESNET_BLOCKS
        assert dataclasses.asdict(cfg) == dataclasses.asdict(default)


@pytest.fixture(scope="module")
def networks():
    return {"detector": fw.detector(), "vitpose": fw.vitpose(),
            "resnet": fw.resnet()}


# each network's widest tensors, by their mm names
SHAPES = {
    "detector": {
        "backbone.stages.3.blocks.1.attn.w_msa.qkv.weight": (2304, 768),
        "backbone.stages.3.blocks.1.attn.w_msa.relative_position_bias_table":
            (169, 24),
        "backbone.stages.3.blocks.1.ffn.layers.0.0.weight": (3072, 768),
        "neck.lateral_convs.3.conv.weight": (256, 768, 1, 1),
        "neck.fpn_convs.0.conv.weight": (256, 256, 3, 3),
        "rpn_head.rpn_reg.weight": (12, 256, 1, 1),
        "roi_head.bbox_head.shared_fcs.0.weight": (1024, 12544),
        "roi_head.bbox_head.fc_cls.weight": (2, 1024),
    },
    "vitpose": {
        "backbone.patch_embed.projection.weight": (1280, 3, 16, 16),
        "backbone.pos_embed": (1, 192, 1280),
        "backbone.layers.1.attn.qkv.weight": (3840, 1280),
        "backbone.layers.1.ffn.layers.0.0.weight": (5120, 1280),
        "head.deconv_layers.0.weight": (1280, 256, 4, 4),
        "head.final_layer.weight": (17, 256, 1, 1),
    },
    "resnet": {
        "backbone.layer3.0.conv2.weight": (256, 256, 3, 3),
        "backbone.layer4.0.conv3.weight": (2048, 512, 1, 1),
        "backbone.layer4.0.downsample.0.weight": (2048, 1024, 1, 1),
        "head.fc.weight": (6, 2048),
    },
}
CARRIERS = {"detector": swin_maskrcnn_from_jax, "vitpose": vitpose_from_jax,
            "resnet": resnet_from_jax}


@pytest.mark.parametrize("name", SHAPES)
def test_state_dict_is_full_width(networks, name):
    sd = networks[name].state_dict
    for k, shape in SHAPES[name].items():
        assert sd[k].shape == shape, k
    if name == "detector":
        # the raised foreground bias that lets detections through
        assert sd["roi_head.bbox_head.fc_cls.bias"][0] > 5


@pytest.mark.parametrize("name", SHAPES)
def test_both_loaders_consume_the_whole_state_dict(networks, name):
    net = networks[name]
    assert net.printed == ("", "")
    missing, unexpected = net.port.load_state_dict(
        {k: torch.from_numpy(v) for k, v in net.state_dict.items()},
        strict=False)
    assert missing == [] and unexpected == []
    for k, v in net.port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), net.state_dict[k], err_msg=k)


def _example(name):
    if name == "detector":
        return jnp.zeros((1, 64, 64, 3), jnp.float32)
    if name == "vitpose":
        return jnp.zeros((1, 256, 192, 3), jnp.float32)
    return jnp.zeros((1, 224, 224, 3), jnp.float32)


@pytest.mark.parametrize("name", SHAPES)
def test_converted_variables_fit_the_jax_model(networks, name):
    net = networks[name]
    with jax.enable_x64(False):         # float32 parameters, as in production
        want = jax.eval_shape(net.jax_model.init, jax.random.PRNGKey(0),
                              _example(name))
    got = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                       net.jax_vars)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype


@pytest.mark.parametrize("name", SHAPES)
def test_port_carrier_gives_the_state_dict_back(networks, name):
    net = networks[name]
    back = CARRIERS[name](net.jax_vars)
    assert set(back) == set(net.state_dict)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), net.state_dict[k], err_msg=k)

"""ResNet classifier (mmpretrain; ResNet-152 in the ``parity`` and
``serving`` configurations), the collar-ID network.

Program: ``ResNetClassifier`` over a ``ResNetConfig``. Reference:
``reference/nets.py::ResNetClassifier``.
"""

from __future__ import annotations

from portbench.reference import nets

INIT = {}


def program(block: dict, dtype, device):
    from macaque_tpu_torch.nn import ResNetClassifier, ResNetConfig

    return ResNetClassifier(ResNetConfig(depth=block["depth"],
                                         num_classes=block["num_classes"],
                                         compute_dtype=dtype), device=device)


def loaded(model, block: dict, state: dict) -> None:
    pass


def perception_kwargs(block: dict) -> dict:
    return {}


def reference(block: dict):
    return nets.frozen(nets.ResNetClassifier(block))


def quantize(net, block: dict, lower: bool) -> None:
    pass


def tiny(block: dict) -> dict:
    return dict(block, depth=50)

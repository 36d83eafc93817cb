"""Compatibility adapters for reference/anipose-style APIs (port of
``macaque_tpu/compat``)."""

from macaque_tpu_torch.compat.aniposelib import CameraGroup

__all__ = ["CameraGroup"]

"""Device mesh and sharding helpers, in one process.

Port of ``macaque_tpu/core/mesh.py``. The reference's only scale-out
story is "run one process per GPU" (info_replication.md:14); the JAX
package's is one ``jax.sharding.Mesh`` with a ``cam`` and a ``frame`` axis,
whose batch axis XLA partitions implicitly. Here a mesh is a (cam, frame)
grid of ``torch.device`` entries. Stage code runs one shard of a batch on
each entry with that device's copy of the weights or cameras, launching
every shard from one host thread before it reads anything back
(:func:`map_shards`), and gathers the shards back along the batch axis
(:func:`gather_shards`): the two steps XLA took for the JAX package.

A device may appear more than once: a mesh of eight ``cpu`` entries, or
four of ``cuda:0`` on one card, runs the sharded path on one device, as
JAX's ``--xla_force_host_platform_device_count`` dry run does
(``__graft_entry__.py:49-74``).
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """A grid of devices with named axes (``jax.sharding.Mesh``'s
    ``devices``, ``axis_names``, ``shape`` and ``size``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-D device grid for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def device_list(self) -> list:
        """The entries in row-major order: the order of a batch's shards."""
        return list(self.devices.flat)

    def distinct(self) -> list:
        """Each device once, in the order of first appearance."""
        return list(dict.fromkeys(self.device_list))

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.device_list]})"


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per array dimension, a
    mesh axis name, a tuple of names, or None (that dimension whole)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)


P = PartitionSpec


class NamedSharding(NamedTuple):
    mesh: Mesh
    spec: PartitionSpec


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("cam", "frame"),
    cam_axis_size: Optional[int] = None,
    devices=None,
) -> Mesh:
    """Build a 2D (cam, frame) mesh over ``devices`` (every CUDA device
    when None; without one it raises, it never falls back to the CPU).

    ``cam_axis_size`` fixes the camera axis (e.g. 4 or 8 streams); the
    frame axis absorbs the remaining devices. With fewer devices than
    cameras the cam axis shrinks to the device count and camera streams
    round-robin. ``devices`` may repeat a device (``["cpu"] * 8``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "(e.g. ['cpu'] * 8) for a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    # "cuda" names the current card: give it its index, so that entries
    # and the modules already on that card compare equal
    devices = [torch.device("cuda", torch.cuda.current_device())
               if torch.device(d) == torch.device("cuda")
               else torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if cam_axis_size is None:
        cam_axis_size = min(n, 8)
        while n % cam_axis_size != 0:
            cam_axis_size -= 1
    frame_axis = n // cam_axis_size
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(cam_axis_size, frame_axis),
                axis_names=tuple(axis_names))


def shard_over(mesh: Mesh, *axis_names: Optional[str]) -> NamedSharding:
    """A sharding placing array dims on the given mesh axes (None = that
    dim whole). E.g. ``shard_over(mesh, 'cam', 'frame')`` shards a
    (n_cam, n_frame, ...) batch."""
    return NamedSharding(mesh, P(*axis_names))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def device_put(x, sharding: NamedSharding, dtype=None) -> list:
    """Place ``x`` (a numpy array or a tensor) by ``sharding``: one tensor
    per mesh entry, in :attr:`Mesh.device_list` order, each the block of
    ``x`` that entry holds (a sharded dim must divide evenly, as in JAX).
    Entries of one device that hold the same block share one tensor."""
    mesh, spec = sharding
    x = torch.as_tensor(x)
    axis_of = {a: i for i, a in enumerate(mesh.axis_names)}
    grid = mesh.devices.shape
    placed: dict = {}
    out = []
    for flat, dev in enumerate(mesh.device_list):
        idx = np.unravel_index(flat, grid)
        sl = []
        for d in range(x.dim()):
            part = spec[d] if d < len(spec) else None
            if part is None:
                sl.append(slice(None))
                continue
            names = (part,) if isinstance(part, str) else tuple(part)
            sizes = [grid[axis_of[a]] for a in names]
            parts = math.prod(sizes)
            if x.shape[d] % parts:
                raise ValueError(f"dim {d} of size {x.shape[d]} does not "
                                 f"split evenly over {parts} devices")
            pos = int(np.ravel_multi_index(
                [idx[axis_of[a]] for a in names], sizes)) if names else 0
            step = x.shape[d] // parts
            sl.append(slice(pos * step, (pos + 1) * step))
        key = (dev, tuple((s.start, s.stop) for s in sl))
        if key not in placed:
            placed[key] = x[tuple(sl)].to(device=dev, dtype=dtype)
        out.append(placed[key])
    return out


def device_put_sharded_batch(x, mesh: Mesh, *axis_names):
    return device_put(x, shard_over(mesh, *axis_names))


# ------------------------------------------------------------------
# Production-pipeline sharding: batch-axis sharding with padding.
#
# Every stage's device work (the perception's chunks, step 2's affinity,
# SVT and triangulations, step 3's traces, step 4's Viterbi, DLT,
# refinement and reprojection) is batched along one axis whose elements
# are independent. Sharding that axis over the whole mesh and keeping a
# copy of the weights on each device runs the same code on every shard.
# The batch is padded up to a multiple of the entry count (as XLA
# requires even sharding); callers cut the original length back off the
# gathered result.


def batch_spec(mesh: Mesh, axis: int = 0) -> PartitionSpec:
    """PartitionSpec sharding array dim ``axis`` over ALL mesh axes."""
    return P(*([None] * axis + [tuple(mesh.axis_names)]))


def pad_to_multiple(x: np.ndarray, m: int, axis: int = 0):
    """Pad ``axis`` with edge copies up to a multiple of ``m``. Edge
    padding (not zeros) keeps padded lanes numerically tame in solvers;
    callers drop them regardless."""
    n = x.shape[axis]
    rem = (-n) % m
    if rem == 0:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad, mode="edge"), n


def put_batch_sharded(x, mesh: Optional[Mesh], axis: int = 0, dtype=None):
    """Pad + place ``x`` with dim ``axis`` sharded over the mesh.

    Returns ``(shards, orig_len)``: one tensor per mesh entry (in
    ``dtype`` when given). With ``mesh=None`` ``x`` passes through
    unchanged (the single-device path)."""
    if mesh is None:
        return x, x.shape[axis]
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    x, n = pad_to_multiple(np.asarray(x), mesh.size, axis)
    return device_put(x, NamedSharding(mesh, batch_spec(mesh, axis)),
                      dtype), n


def _to(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree, device=device)
    if isinstance(tree, torch.nn.Module):
        if all(t.device == device for t in
               [*tree.parameters(), *tree.buffers()]):
            return tree
        return copy.deepcopy(tree).to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree


def put_replicated(tree, mesh: Optional[Mesh]):
    """Replicate a tree (tensors, modules, camera tuples, weights) over the
    mesh: one copy on each distinct device (a module already there is
    used as it is), returned once per mesh entry in
    :attr:`Mesh.device_list` order. With ``mesh=None`` ``tree`` passes
    through."""
    if mesh is None:
        return tree
    copies = {d: _to(tree, d) for d in mesh.distinct()}
    return [copies[d] for d in mesh.device_list]


def home_device(mesh: Optional[Mesh], device=None) -> torch.device:
    """Where a stage keeps what it does not shard: ``device`` when given,
    else the mesh's first entry, else (no mesh) the card
    (``core/device.py``)."""
    from macaque_tpu_torch.core.device import resolve_device

    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a macaque_tpu_torch.core.mesh.Mesh "
                        f"(make_mesh), got {type(mesh).__name__}")
    if mesh is None or device is not None:
        return resolve_device(device)
    return mesh.device_list[0]


def stage_mesh(mesh: Optional[Mesh], device=None):
    """A stage's mesh and home device (:func:`home_device`). Without a
    mesh the stage runs on a mesh of one entry, its home device, so that
    one path serves both: its batches go through :func:`put_batch_sharded`,
    :func:`map_shards` and :func:`gather_shards` whatever the mesh."""
    home = home_device(mesh, device)
    return (make_mesh(devices=[home]) if mesh is None else mesh), home


def device_guard(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device (the current device
    that a C entry point launches on), else nothing."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def map_shards(fn, mesh: Mesh, *per_entry) -> list:
    """``fn(*args_i)`` for every mesh entry i, each argument list being
    :func:`put_batch_sharded`'s shards or :func:`put_replicated`'s copies,
    under that entry's device guard. Every shard is launched from this
    thread before anything is read back, so long as ``fn`` itself does
    not read a device value (on CUDA the devices then run together)."""
    outs = []
    for i, dev in enumerate(mesh.device_list):
        with device_guard(dev):
            outs.append(fn(*(a[i] for a in per_entry)))
    return outs


def gather_shards(outs: list, n: int, axis: int = 0, device=None):
    """Concatenate the shards' outputs along ``axis`` on ``device`` (the
    first shard's when None; ``"cpu"`` reads them back) and cut them to
    the batch's ``n``. Outputs that are tuples gather element by element."""
    first = outs[0]
    if isinstance(first, (tuple, list)):
        return type(first)(gather_shards([o[k] for o in outs], n, axis, device)
                           for k in range(len(first)))
    dev = first.device if device is None else torch.device(device)
    return torch.cat([o.to(dev) for o in outs], axis).narrow(axis, 0, n)


def live_shards(shards: list, n: int, axis: int = 0) -> list[int]:
    """The entries whose shard holds at least one of the batch's ``n``
    real elements (the others hold edge padding only)."""
    size = shards[0].shape[axis]
    return [i for i in range(len(shards)) if i * size < n]

"""Device mesh and batch staging on local devices — port of the local half
of ``avenir_tpu/parallel/mesh.py``.

The device model.  A mesh spans the devices of ONE process:

- :func:`local_devices` on ``cuda`` lists ``cuda:0 … cuda:{n-1}``, the
  cards ``torch.cuda.device_count()`` sees; on the CPU it lists as many
  shard slots as the JAX package sees in the same environment — the value
  of ``--xla_force_host_platform_device_count`` in ``XLA_FLAGS``, 1
  without it (read as a string, importing nothing).  So one conf resolves
  to the same mesh in both packages: ``shard.devices=8`` runs in both on
  a host that forces eight host devices and is refused in both without.
  Every CPU slot is the one host device; slot ``i`` is labelled
  ``cpu:i``, as the JAX package labels its ``i``-th host device.
- A :class:`Mesh` is a small record: the devices (row-major over the
  axes), the axis names and the shape.  One H100 is a one-device mesh.
- A batch sharded over the ``data`` axis is :class:`Blocks`: the padded
  batch cut into equal row blocks, block ``i`` on the ``i``-th device
  along that axis.  ``parallel/collectives.py`` folds each block on its
  own device and reduces the partials in shard order with tensor sums.

There is no process group, no socket and no collective library: where the
JAX package runs ``shard_map`` and ``psum`` over local devices in one
process, the port launches per device and adds.  Joining processes
(``init_distributed``, ``make_hybrid_mesh``, ``all_process_sum_state``,
the fleet join, ``collective.wait``) is ROADMAP.md, Queue 1 item 7h.

Count-neutral padding: every count table drops a code or label of −1
(the drop-invalid contract), so padding a batch with −1 rows changes no
statistic; that is how a ragged chunk meets the equal-block split.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.device import resolve_device, to_device

_HOST_COUNT = re.compile(r"--xla_force_host_platform_device_count=(\d+)")


def host_slots() -> int:
    """The CPU's shard slots: the last
    ``--xla_force_host_platform_device_count`` in ``XLA_FLAGS``, else 1."""
    found = _HOST_COUNT.findall(os.environ.get("XLA_FLAGS", ""))
    return int(found[-1]) if found else 1


def local_devices(device=None) -> List[torch.device]:
    """The devices a mesh on ``device``'s kind may span (``cuda`` unless
    the caller asks for the CPU): every CUDA card of this process, or the
    CPU's :func:`host_slots`."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * host_slots()


@dataclass(frozen=True)
class Mesh:
    """Local devices laid out over named axes (row-major)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    @property
    def sizes(self) -> dict:
        """axis name → size, the JAX package's ``mesh.shape`` mapping."""
        return dict(zip(self.axis_names, self.shape))

    def _axis_indices(self, axis: str) -> List[int]:
        k = self.axis_names.index(axis)
        stride = int(np.prod(self.shape[k + 1:], dtype=np.int64))
        return [i * stride for i in range(self.shape[k])]

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis``, every other axis at index 0."""
        return tuple(self.devices[i] for i in self._axis_indices(axis))

    def device_at(self, **coords: int) -> torch.device:
        """The device at ``coords`` (axis name → index; an axis left out
        is at index 0)."""
        flat = 0
        for name, size in zip(self.axis_names, self.shape):
            flat = flat * size + coords.get(name, 0)
        return self.devices[flat]

    def axis_labels(self, axis: str) -> List[str]:
        """``<type>:<index>`` of each device along ``axis`` (a CPU slot's
        index is its place in the mesh)."""
        return [f"{self.devices[i].type}:"
                f"{i if self.devices[i].index is None else self.devices[i].index}"
                for i in self._axis_indices(axis)]


def make_mesh(axis_names: Tuple[str, ...] = ("data",),
              shape: Optional[Tuple[int, ...]] = None,
              devices: Optional[Sequence[torch.device]] = None,
              device=None) -> Mesh:
    """A mesh over ``devices`` (default: :func:`local_devices` of
    ``device``).  Without a shape, one axis spans every device; with more
    axes, each trailing axis takes a factor 2 where the count divides and
    the leading axis the rest — the JAX package's rule."""
    devs = tuple(devices if devices is not None else local_devices(device))
    n = len(devs)
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        else:
            trailing = []
            rem = n
            for _ in axis_names[1:]:
                f = 2 if rem % 2 == 0 and rem >= 2 else 1
                trailing.append(f)
                rem //= f
            shape = (rem, *trailing)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    return Mesh(devs, tuple(axis_names), shape)


def pad_batch(n_target: int, *arrays: np.ndarray, fill: int = -1):
    """Pad axis 0 of each array to ``n_target`` rows through
    :func:`avenir_tpu_torch.core.encoding.pad_rows`, the one ballast fill."""
    from avenir_tpu_torch.core.encoding import pad_rows

    return pad_rows(n_target, *arrays, fill=fill)


def padded_size(n: int, num_shards: int) -> int:
    return ((n + num_shards - 1) // num_shards) * num_shards


def shard_pad_target(n: int, num_shards: int) -> int:
    """Row target of a staged chunk: the next power of two ≥ n, rounded up
    to a multiple of ``num_shards`` (every shard gets an equal block of at
    least one row).  For a fixed shard count the targets are one per pow-2
    bucket, so a chunk stream with a ragged tail stages a bounded set of
    shapes."""
    if n < 1:
        raise ValueError(f"cannot stage an empty chunk (n={n})")
    t = 1
    while t < n:
        t *= 2
    return padded_size(t, num_shards)


@dataclass(frozen=True, eq=False)
class Blocks:
    """One array sharded over a mesh axis: ``parts[i]``, the ``i``-th
    equal row block, lives on the ``i``-th device of that axis.  ``shape``
    and ``dtype`` describe the whole batch, as a sharded array's do."""

    parts: Tuple[torch.Tensor, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        first = self.parts[0]
        return (sum(int(p.shape[0]) for p in self.parts),
                *tuple(first.shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def __getitem__(self, index) -> "Blocks":
        """Columns of every block: ``blocks[:, cols]`` (rows stay whole)."""
        rows, cols = index
        if rows != slice(None):
            raise IndexError("Blocks select columns only: blocks[:, cols]")
        cols = torch.as_tensor(np.asarray(cols), dtype=torch.long)
        return Blocks(tuple(p[:, cols.to(p.device)] for p in self.parts))

    def on(self, devices: Sequence[torch.device]) -> bool:
        """Is this batch split over exactly these devices?"""
        return (len(self.parts) == len(devices)
                and all(p.device == torch.device(d)
                        for p, d in zip(self.parts, devices)))


def shard_parts(x) -> Tuple[torch.Tensor, ...]:
    """The per-shard tensors of a staged array: a :class:`Blocks`' parts,
    or a lone tensor as the one block of a one-device mesh."""
    return x.parts if isinstance(x, Blocks) else (x,)


def device_put_sharded_batch(mesh: Mesh, *arrays, data_axis: str = "data"):
    """Pad axis 0 to a multiple of the data axis' size and cut each host
    array into equal row blocks, block ``i`` copied to the ``i``-th device
    along ``data_axis``.  One array comes back as its :class:`Blocks`,
    several as a list (None entries stay None)."""
    devs = mesh.axis_devices(data_axis)
    n = next(a.shape[0] for a in arrays if a is not None)
    padded = pad_batch(padded_size(n, len(devs)), *arrays)
    if len(arrays) == 1:
        padded = [padded]
    out = []
    for a in padded:
        if a is None:
            out.append(None)
            continue
        per = a.shape[0] // len(devs)
        out.append(Blocks(tuple(
            to_device(np.ascontiguousarray(a[i * per:(i + 1) * per]), d)
            for i, d in enumerate(devs))))
    return out if len(out) > 1 else out[0]


def process_local_batch(mesh: Mesh, array: np.ndarray,
                        data_axis: str = "data") -> Blocks:
    """A batch built from this process's rows.  One process holds every
    row, so this is :func:`device_put_sharded_batch`; assembling rows from
    several processes is ROADMAP.md, Queue 1 item 7h."""
    return device_put_sharded_batch(mesh, array, data_axis=data_axis)


def is_wide(mesh: Optional[Mesh], data_axis: str = "data") -> bool:
    """Does ``mesh``'s data axis span two or more devices?  Below that a
    ``mesh=`` seam runs its single-device code, as the JAX package's
    ``maybe_shard_batch`` places a batch whole on a one-device axis."""
    return mesh is not None and mesh.size(data_axis) > 1


def maybe_shard_batch(mesh: Optional[Mesh], *arrays,
                      data_axis: str = "data") -> list:
    """Split the batch axis over ``mesh`` when its data axis spans more
    than one device, else place each array whole on the mesh's device (the
    host without a mesh) — the one dispatch policy of the JAX package's
    ``mesh=`` seams.  An array already split over this mesh's data devices
    passes through untouched (the sharded feeder stage ran this on its
    worker thread); one split over other devices is refused.  Always
    returns a list matching ``arrays``."""
    wide = is_wide(mesh, data_axis)

    def placed(a) -> bool:
        if isinstance(a, Blocks):
            if mesh is None or not a.on(mesh.axis_devices(data_axis)):
                raise ValueError(
                    "the batch is split over other devices than this "
                    "mesh's data axis; stage host arrays instead")
            return True
        return a is None or (not wide and isinstance(a, torch.Tensor))

    if all([placed(a) for a in arrays]):
        return list(arrays)
    if any(isinstance(a, Blocks) for a in arrays):
        raise ValueError("a batch is staged only in part; stage all of its "
                         "arrays together")
    host = tuple(None if a is None else
                 a.numpy(force=True) if isinstance(a, torch.Tensor)
                 else np.asarray(a) for a in arrays)
    if wide:
        out = device_put_sharded_batch(mesh, *host, data_axis=data_axis)
        return out if len(host) > 1 else [out]
    dev = mesh.devices[0] if mesh is not None else torch.device("cpu")
    return [None if a is None else to_device(a, dev) for a in host]


def mesh_on_cuda(mesh: Optional[Mesh]) -> bool:
    """Is every device of ``mesh`` a CUDA card?  The port's counterpart of
    the JAX package's ``mesh_on_tpu``: a mesh of cards runs the kernels
    once per shard, a CPU mesh (the host slots) the plain counts."""
    return mesh is not None and all(d.type == "cuda" for d in mesh.devices)


def place_batch(mesh: Optional[Mesh], device, *arrays,
                data_axis: str = "data") -> list:
    """A model's chunk placement: split over ``mesh``'s data axis
    (:func:`maybe_shard_batch`) when a mesh is given, else each array
    whole on ``device`` (None entries stay None).  Always a list."""
    if mesh is not None:
        return maybe_shard_batch(mesh, *arrays, data_axis=data_axis)
    return [None if a is None else to_device(a, device) for a in arrays]

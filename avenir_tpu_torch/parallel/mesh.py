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

Where the JAX package runs ``shard_map`` and ``psum`` over local devices
in one process, the port launches per device and adds.  Across processes
(the fleet of ``python -m avenir_tpu_torch.launch``) it joins one
``torch.distributed`` group on the ``gloo`` backend
(:func:`init_distributed`: a ``TCPStore`` rendezvous hosted by process 0
at ``AVENIR_COORDINATOR_ADDRESS``, behind a bounded, jittered probe that
raises the typed ``LaunchError``), and what crosses processes is host
state — int64 totals, float64 moments, gradient partials — packed into
one byte gather (:func:`all_process_sum_state`), as the JAX package
gathers raw bytes on the host.  No device tensor crosses: a fleet on one
card is N processes, each with its own CUDA context on ``cuda:0``.  A
mesh that spans processes (:func:`make_hybrid_mesh`, ``ShardSpec``'s
global plan) lists each process's local devices along its leading
axis; a process folds only its own row block on its own devices.

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
    """A batch built from this process's rows: each process passes its own
    rows and places them over its own devices of ``mesh``'s data axis (no
    row crosses a process; the global batch is the concatenation in
    process order).  In one process that is
    :func:`device_put_sharded_batch`."""
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


# ---------------------------------------------------------------------------
# the process plane
# ---------------------------------------------------------------------------

# this process's last successful join: tracing is usually configured after
# the join (the join comes before any device work), so the facts are kept
# here and journaled by the seams that know the journal exists
_LAST_JOIN: Optional[dict] = None


def process_grid() -> Tuple[int, int]:
    """(process index, process count) of the joined ``torch.distributed``
    group; (0, 1) in a process that joined none."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def last_join() -> Optional[dict]:
    """The recorded ``fleet.join`` payload of this process's join, or None
    when it joined no fleet."""
    return _LAST_JOIN


def journal_fleet_join(coordinator: str, nprocs: int, attempts: int,
                       wall_ms: float) -> None:
    """Journal one ``fleet.join`` event (coordinator, fleet size, join
    attempts, join wall), at most once per journal per coordinator: the
    join-time emission (a no-op while tracing is off) and the later replay
    from ``ShardSpec.announce`` share the key."""
    from avenir_tpu_torch.telemetry import spans as tel

    tel.tracer().event_once("fleet.join", str(coordinator),
                            coordinator=coordinator,
                            nprocs=int(nprocs), attempts=int(attempts),
                            wall_ms=round(float(wall_ms), 3))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout_s: Optional[float] = None,
                     attempts: Optional[int] = None,
                     init_method: Optional[str] = None) -> int:
    """Join a multi-process run; returns this process's index.

    Idempotent, and a no-op (index 0) when neither the arguments nor
    ``AVENIR_COORDINATOR_ADDRESS`` describe a fleet.  The arguments
    default to the launcher's environment (``AVENIR_NUM_PROCESSES``,
    ``AVENIR_PROCESS_ID``, ``AVENIR_JOIN_TIMEOUT_SEC`` (300),
    ``AVENIR_JOIN_ATTEMPTS`` (3)).  The group is ``torch.distributed`` on
    ``gloo``, rendezvousing at a ``TCPStore`` that process 0 hosts at the
    coordinator's ``host:port`` — or at torch's own ``init_method`` (a
    ``file://`` store) when one is given.

    The join is bounded, as the JAX package's: a non-zero rank first
    probes the coordinator's TCP endpoint under the decorrelated-jitter
    backoff for up to ``timeout_s``, and an address where nothing accepts
    raises the typed ``LaunchError`` naming it; the rendezvous itself
    carries the timeout and is retried up to ``attempts`` times.  Nothing
    falls back to a single process.  The join is recorded for the journal
    (:func:`last_join`, ``fleet.join``), and an exit hook destroys the
    group before interpreter teardown (:func:`_destroy_group`)."""
    import time

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if coordinator_address is None and num_processes is None \
            and init_method is None:
        if "AVENIR_COORDINATOR_ADDRESS" not in env:
            return 0                        # one process, nothing to join
        coordinator_address = env.get("AVENIR_COORDINATOR_ADDRESS")
        if env.get("AVENIR_NUM_PROCESSES"):
            num_processes = int(env["AVENIR_NUM_PROCESSES"])
        if env.get("AVENIR_PROCESS_ID"):
            process_id = int(env["AVENIR_PROCESS_ID"])
    if num_processes is None or process_id is None:
        raise ValueError(
            "init_distributed needs the fleet size and this process's "
            "index (num_processes / process_id, or AVENIR_NUM_PROCESSES / "
            "AVENIR_PROCESS_ID)")
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"process_id {process_id} is outside a fleet of "
                         f"{num_processes}")
    if init_method is None and not coordinator_address:
        raise ValueError("init_distributed needs a coordinator address "
                         "(host:port) or an init_method")
    if attempts is None:
        attempts = int(env.get("AVENIR_JOIN_ATTEMPTS", "3"))
    if timeout_s is None:
        timeout_s = float(env.get("AVENIR_JOIN_TIMEOUT_SEC", "300"))
    from datetime import timedelta

    from avenir_tpu_torch.utils.retry import RetryPolicy

    policy = RetryPolicy(max_attempts=max(int(attempts), 1), backoff_s=0.5)
    timeout = timedelta(seconds=max(float(timeout_s), 1.0))
    t0 = time.monotonic()
    if init_method is None:
        host, port = _split_address(str(coordinator_address))
        if int(process_id) != 0:
            # rank 0 hosts the store (nothing to probe); every other rank
            # waits for it to become reachable within the bounded window
            _wait_for_coordinator(str(coordinator_address), float(timeout_s))
    last_err: Optional[BaseException] = None
    sleep_s = 0.0
    for attempt in range(1, policy.max_attempts + 1):
        try:
            if init_method is not None:
                dist.init_process_group(
                    "gloo", init_method=init_method, timeout=timeout,
                    world_size=int(num_processes), rank=int(process_id))
            else:
                store = dist.TCPStore(
                    host, port, world_size=int(num_processes),
                    is_master=int(process_id) == 0, timeout=timeout,
                    wait_for_workers=False)
                dist.init_process_group(
                    "gloo", store=store, timeout=timeout,
                    world_size=int(num_processes), rank=int(process_id))
            import atexit

            atexit.register(_destroy_group)
            _record_join(coordinator_address or init_method, attempt,
                         (time.monotonic() - t0) * 1e3)
            return dist.get_rank()
        except ValueError:
            raise                          # malformed arguments: fail fast
        except Exception as e:             # timeout, refused, store error
            last_err = e
        if dist.is_initialized():          # clear a half-joined group
            dist.destroy_process_group()
        if attempt < policy.max_attempts:
            sleep_s = policy.next_backoff(sleep_s)
            time.sleep(sleep_s)
    from avenir_tpu_torch.launch import LaunchError

    where = coordinator_address or init_method
    raise LaunchError(
        f"fleet join failed: coordinator {where!r} "
        f"(process {process_id} of {num_processes}) did not accept the "
        f"join within {timeout_s:g}s on any of {policy.max_attempts} "
        f"attempt(s) — check the coordinator address/port and that "
        f"process 0 is up: {last_err!r}") from last_err


def _split_address(address: str) -> Tuple[str, int]:
    host, _, port_s = address.rpartition(":")
    try:
        return host or "localhost", int(port_s)
    except ValueError:
        from avenir_tpu_torch.launch import LaunchError

        raise LaunchError(
            f"coordinator address {address!r} is not host:port") from None


def _wait_for_coordinator(address: str, timeout_s: float) -> None:
    """Wait, bounded and jittered, for the coordinator's TCP endpoint: a
    plain connect retried under ``RetryPolicy.next_backoff`` (base 0.2 s,
    cap 2 s) until it accepts or ``timeout_s`` runs out, then the typed
    ``LaunchError`` naming the address."""
    import socket
    import time

    from avenir_tpu_torch.utils.retry import RetryPolicy

    host, port = _split_address(address)
    policy = RetryPolicy(max_attempts=1, backoff_s=0.2, backoff_cap_s=2.0)
    deadline = time.monotonic() + max(float(timeout_s), 0.1)
    sleep_s = 0.0
    last: Optional[BaseException] = None
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            from avenir_tpu_torch.launch import LaunchError

            raise LaunchError(
                f"fleet join failed: coordinator {address!r} was not "
                f"reachable within {timeout_s:g}s — check the address/"
                f"port and that process 0 (the coordinator) is up: "
                f"{last!r}") from last
        try:
            sock = socket.create_connection(
                (host, port), timeout=min(2.0, max(remaining, 0.1)))
            sock.close()
            return
        except OSError as e:
            last = e
        sleep_s = min(policy.next_backoff(sleep_s),
                      max(deadline - time.monotonic(), 0.0))
        time.sleep(sleep_s)


def _destroy_group() -> None:
    """The exit hook of a joined process: destroy the group if it is
    still up.

    Exit hooks run while the interpreter is still whole.  Without this
    one the group lives into interpreter teardown with gloo's native
    threads (``pt_gloo_runloop`` ×2, ``gloo_tcp_loop``) running.  A
    runloop thread drops its reference to a finished collective's tensors
    after it wakes the caller.  When the caller had already dropped them
    (``_gather_bytes``'s temporaries), the tensor owns its Python object.
    That last release takes the GIL; if the main thread has begun
    finalizing by then, Python ends the thread with a forced unwind
    through a noexcept destructor, and the process aborts with
    "terminate called without an active exception" after its work is
    done.  ``destroy_process_group`` joins those threads first."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _record_join(coordinator, attempts: int, wall_ms: float) -> None:
    """Record (and journal, when tracing is already on) this process's
    successful join."""
    global _LAST_JOIN
    _LAST_JOIN = {"coordinator": str(coordinator),
                  "nprocs": process_grid()[1],
                  "attempts": int(attempts),
                  "wall_ms": round(float(wall_ms), 3)}
    journal_fleet_join(**_LAST_JOIN)


def make_hybrid_mesh(axis_names: Tuple[str, ...] = ("data", "model"),
                     ici_shape: Optional[Tuple[int, ...]] = None,
                     dcn_shape: Optional[Tuple[int, ...]] = None,
                     device=None,
                     devices: Optional[Sequence[torch.device]] = None
                     ) -> Mesh:
    """A mesh whose leading axis spans processes and whose trailing axes
    stay within one process's devices — the JAX package's layout.  In one
    process it is :func:`make_mesh` (``ici_shape`` left-padded with 1s).
    Across processes the default puts the processes on the leading axis
    and this process's local devices on the last; device (p, …, j) is
    process ``p``'s ``j``-th local device, listed by its local label.
    ``devices`` names the local devices each process lays out (default:
    every local device of ``device``'s kind)."""
    nprocs = process_grid()[1]
    local = list(devices) if devices is not None else local_devices(device)
    if nprocs <= 1:
        shape = None
        if ici_shape is not None:
            shape = tuple(ici_shape)
            if len(shape) < len(axis_names):
                shape = (len(axis_names) - len(shape)) * (1,) + shape
        return make_mesh(axis_names, shape=shape, devices=local)
    if dcn_shape is None:
        dcn_shape = (nprocs,) + (1,) * (len(axis_names) - 1)
    if ici_shape is None:
        ici_shape = (1,) * (len(axis_names) - 1) + (len(local),)
    if int(np.prod(dcn_shape)) != nprocs or \
            int(np.prod(ici_shape)) != len(local):
        raise ValueError(
            f"hybrid mesh dcn {tuple(dcn_shape)} × ici {tuple(ici_shape)} "
            f"does not cover {nprocs} process(es) × {len(local)} local "
            f"device(s)")
    shape = tuple(d * i for d, i in zip(dcn_shape, ici_shape))
    # (dcn..., ici...) interleaved axis-wise, as the JAX package lays out
    # a multi-process CPU mesh; each process's devices by local index
    grid = np.arange(nprocs * len(local)).reshape(
        tuple(dcn_shape) + tuple(ici_shape))
    k = len(dcn_shape)
    perm = [a for i in range(k) for a in (i, k + i)]
    flat = grid.transpose(perm).reshape(shape).reshape(-1)
    devices = tuple(local[int(i) % len(local)] for i in flat)
    return Mesh(devices, tuple(axis_names), shape)


def _gather_bytes(payload: bytes) -> List[bytes]:
    """Every process's ``payload``, in process order: one int64 length
    gather and one byte gather on the gloo group (CPU tensors)."""
    import torch.distributed as dist

    n = dist.get_world_size()
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(lens, torch.tensor([len(payload)], dtype=torch.int64))
    width = max(max(int(t) for t in lens), 1)
    buf = torch.zeros(width, dtype=torch.uint8)
    if payload:
        buf[:len(payload)] = torch.frombuffer(bytearray(payload),
                                              dtype=torch.uint8)
    bufs = [torch.empty(width, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(bufs, buf)
    return [bufs[p][:int(lens[p])].numpy().tobytes() for p in range(n)]


def _pack_state(state: dict) -> bytes:
    import json

    arrays = {k: np.ascontiguousarray(np.asarray(state[k]))
              for k in sorted(state)}
    header = json.dumps(
        [[k, a.dtype.str, list(a.shape)] for k, a in arrays.items()]).encode()
    return header + b"\0" + b"".join(a.tobytes() for a in arrays.values())


def _unpack_state(raw: bytes) -> dict:
    import json

    head, _, body = raw.partition(b"\0")
    out = {}
    off = 0
    for key, dt, shape in json.loads(head.decode()):
        dtype = np.dtype(dt)
        nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        out[key] = np.frombuffer(body[off:off + nbytes],
                                 dtype=dtype).reshape(shape)
        off += nbytes
    return out


def _gather_states(state: dict) -> Tuple[int, List[dict]]:
    """(payload bytes, every process's ``state`` in process order): one
    packed byte gather, or ``(0, [state])`` in one process."""
    if process_grid()[1] == 1:
        return 0, [{k: np.asarray(v) for k, v in state.items()}]
    payload = _pack_state(state)
    if len(payload) >= 2 ** 31:
        raise ValueError(
            f"accumulator payload {len(payload)} bytes exceeds the int32 "
            "length-gather limit; shard the state across keys/jobs")
    return len(payload), [_unpack_state(raw)
                          for raw in _gather_bytes(payload)]


def all_process_gather_state(state: dict) -> List[dict]:
    """Every process's ``state`` ({key: array}), in process order, through
    one packed byte gather: a collective every process enters (key sets
    may differ).  In one process, ``[state]`` as numpy arrays."""
    return _gather_states(state)[1]


def all_process_sum_state(state: dict) -> dict:
    """The across-process sum of an accumulator state tree — the job
    layer's end-of-stream reduce when chunks are partitioned over
    processes (Hadoop's one reducer over the mappers' partials).

    A collective every process must enter; key sets may differ (a process
    that owned no chunk contributes nothing, and a missing key counts as
    zero).  Everything rides one payload per process — a length gather and
    one byte gather — as raw bytes, so int64 and float64 cross exactly.
    Per-key sums run on the host in ascending process order, which keeps a
    float sum deterministic.  Keys prefixed ``min:`` / ``max:`` merge by
    elementwise minimum / maximum.  A key whose shape differs between
    processes raises ValueError.  The wall spent in the gather is
    journaled as ``collective.wait`` (the slowest peer shows as the others'
    wait)."""
    import time

    t0 = time.perf_counter()
    nbytes, gathered = _gather_states(state)
    wait_ms = (time.perf_counter() - t0) * 1e3
    if len(gathered) > 1:
        from avenir_tpu_torch.telemetry import spans as tel

        tracer = tel.tracer()
        if tracer.enabled:
            tracer.event("collective.wait", site="all_process_sum_state",
                         wall_ms=round(wait_ms, 3), bytes=nbytes,
                         procs=len(gathered))
    out: dict = {}
    for p, part in enumerate(gathered):
        for key, arr in part.items():
            if key in out:
                if out[key].shape != arr.shape:
                    raise ValueError(
                        f"process {p} contributed {key!r} with shape "
                        f"{arr.shape}, expected {out[key].shape} — schema "
                        f"mismatch across processes")
                if key.startswith("min:"):
                    out[key] = np.minimum(out[key], arr)
                elif key.startswith("max:"):
                    out[key] = np.maximum(out[key], arr)
                else:
                    out[key] = out[key] + arr
            else:
                out[key] = arr.copy()
    return out

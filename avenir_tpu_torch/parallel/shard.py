"""The ``shard.*`` execution policy of the SharedScan — port of
``avenir_tpu/parallel/shard.py``.

``parallel/mesh.py`` lays a batch out over local devices and
``parallel/collectives.py`` folds and reduces it; this module turns the
``shard.*`` keys into one plan that every seam shares:

- ``shard.devices`` — how many local devices the 1-D data mesh spans
  (``all`` or an integer; unset or 0 is off: the unsharded fold, with no
  new launches and no new keys);
- ``shard.data.axis`` — the mesh axis name (default ``data``);
- ``shard.allreduce.quantized`` — reduce the gram through the int8
  ``collectives.quantized_allreduce_sum`` (default off: the exact sum is
  the byte-identity oracle);
- ``shard.proc.axis`` — in a fleet, the name of the leading process axis
  of the global mesh (default ``proc``);
- ``shard.skew.threshold`` / ``.sample`` / ``.fault.device`` /
  ``.fault.ms`` — the straggler probe under ``profile.on``
  (``parallel/skew.py``).

The plan: the chunk feeder (``runtime/feeder.py::sharded_pair_stage``)
ballast-pads each chunk to its pow-2 shard target (label −1 rows, so the
pad changes no statistic) and cuts it into equal row blocks, one per
device; ``ChunkFolder`` folds each block on its device
(``collectives.sharded_scan_step``) and adds the partials; the host
accumulators key the gram under a mesh-qualified ``g_key``
(:attr:`ShardSpec.g_suffix`), so state written under another device
count or axis name is refused at read-out, never summed (or moved on
purpose by ``shard.reshard.on.restore``, ``checkpoint/reshard.py``).

In a fleet of N processes the same keys resolve to a global plan: a
(proc × data) mesh, ``shard.devices`` counting each process's own
devices.  Every process reads every chunk, pads it to the fleet's
target and stages only its own contiguous row block over its own
devices; the fold runs B1–B3 once per local shard and sums the partials
across processes in (process, shard) order on the host
(``collectives.sharded_scan_step(proc_axis=)``), so every process holds
the same totals and process 0 writes.  The gram key carries the process
topology (``:mesh:proc2xdata1``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from avenir_tpu_torch.core.config import ConfigError
from avenir_tpu_torch.parallel.mesh import Mesh


@dataclass(frozen=True)
class ShardSpec:
    """A resolved shard plan: the mesh, its data axis, the reduction and
    the skew probe's settings.  Built once per run (:meth:`from_conf`) and
    passed through ``SharedScan`` / ``ChunkFolder`` / ``WindowedScan`` and
    the feeder, so every seam stages and folds under one topology."""

    mesh: Mesh
    data_axis: str = "data"
    quantized: bool = False
    # a fleet's global plan: the mesh's leading axis spans the processes
    proc_axis: str = "proc"
    num_procs: int = 1
    proc_index: int = 0
    skew_threshold: float = 1.5
    skew_sample: int = 1
    skew_fault_device: int = -1
    skew_fault_ms: float = 0.0

    @staticmethod
    def requested(conf) -> bool:
        """Is a ``shard.*`` topology configured?  The one predicate every
        caller that must agree with :meth:`from_conf`'s off set reads."""
        return conf.get("shard.devices") not in (None, "", "0")

    @classmethod
    def from_conf(cls, conf, device=None) -> Optional["ShardSpec"]:
        """The ``shard.*`` keys → a plan over the local devices of
        ``device``'s kind (``cuda`` unless the caller asks for the CPU;
        ``parallel/mesh.py::local_devices``), or None when unset.  In a
        fleet ``shard.devices`` counts each process's devices and the plan
        is the global (proc × data) mesh.  Refuses, with the JAX package's
        messages, a count that is not a positive integer or ``all``, more
        devices than are attached, and a process axis named like the data
        axis."""
        if not cls.requested(conf):
            return None
        from avenir_tpu_torch.parallel.mesh import (local_devices,
                                                    make_hybrid_mesh,
                                                    make_mesh, process_grid)

        raw = conf.get("shard.devices")
        pid, nprocs = process_grid()
        avail = local_devices(device)
        try:
            n = len(avail) if str(raw).strip().lower() == "all" else int(raw)
        except ValueError:
            raise ConfigError(
                f"shard.devices={raw!r} must be an integer or 'all'")
        if n < 1:
            raise ConfigError(f"shard.devices={raw!r} must be >= 1 or 'all'")
        if n > len(avail):
            raise ConfigError(
                f"shard.devices={n} but only {len(avail)} "
                + ("locally-attached " if nprocs > 1 else "")
                + "device(s) "
                + (f"on process {pid} " if nprocs > 1 else "")
                + f"attached ({avail[0].type})"
                + (" — in a multi-process run shard.devices counts "
                   "per-process devices" if nprocs > 1 else ""))
        axis = conf.get("shard.data.axis", "data")
        quantized = conf.get_bool("shard.allreduce.quantized", False)
        skew = dict(
            skew_threshold=conf.get_float("shard.skew.threshold", 1.5),
            skew_sample=conf.get_int("shard.skew.sample", 1),
            skew_fault_device=conf.get_int("shard.skew.fault.device", -1),
            skew_fault_ms=conf.get_float("shard.skew.fault.ms", 0.0))
        if nprocs > 1:
            proc_axis = conf.get("shard.proc.axis", "proc")
            if proc_axis == axis:
                raise ConfigError(
                    f"shard.proc.axis={proc_axis!r} collides with "
                    f"shard.data.axis — the global mesh needs two distinct "
                    f"axis names")
            return cls(mesh=make_hybrid_mesh((proc_axis, axis),
                                             devices=avail[:n]),
                       data_axis=axis, quantized=quantized,
                       proc_axis=proc_axis, num_procs=nprocs,
                       proc_index=pid, **skew)
        return cls(mesh=make_mesh((axis,), shape=(n,), devices=avail[:n]),
                   data_axis=axis, quantized=quantized, **skew)

    # -- identity -------------------------------------------------------------
    @property
    def num_devices(self) -> int:
        """The data axis' width: each process's device count."""
        return self.mesh.size(self.data_axis)

    @property
    def total_devices(self) -> int:
        """Every device the plan folds over, fleet-wide."""
        return self.num_procs * self.num_devices

    @property
    def is_global(self) -> bool:
        """Does the plan span processes?"""
        return self.num_procs > 1

    @property
    def g_suffix(self) -> str:
        """The qualifier of the gram accumulator key: a run under another
        device count, process count or axis name reads another key, and
        ``ChunkFolder.tables`` refuses the orphaned one."""
        if self.is_global:
            return (f":mesh:{self.proc_axis}{self.num_procs}"
                    f"x{self.data_axis}{self.num_devices}")
        return f":mesh:{self.data_axis}{self.num_devices}"

    def device_kind(self) -> str:
        """The card's name on ``cuda``; ``cpu`` on the host, the JAX
        package's host device kind."""
        import torch

        d = self.mesh.devices[0]
        if d.type == "cuda":
            return torch.cuda.get_device_name(d)
        return d.type

    # -- staging --------------------------------------------------------------
    def pad_target(self, n: int) -> int:
        from avenir_tpu_torch.parallel.mesh import shard_pad_target

        return shard_pad_target(n, self.total_devices)

    def stage(self, ds):
        """An encoded chunk ballast-padded to its pow-2 shard target and
        split over the data devices — the feeder's half of the plan
        (``runtime/feeder.py::sharded_pair_stage`` runs it on the prefetch
        thread).  A staged chunk passes through.  Row ids stay as they are
        (host metadata), and ``valid_rows`` records the true row count, so
        row accounting never counts the pad."""
        from avenir_tpu_torch.core.encoding import EncodedDataset

        valid = ds.valid_rows
        if valid is None and not _staged(ds.codes):
            valid = ds.num_rows
        codes, labels, cont = self.shard_batch(ds.codes, ds.labels, ds.cont)
        return EncodedDataset(
            codes=codes, cont=cont, labels=labels, ids=ds.ids,
            n_bins=ds.n_bins, class_values=ds.class_values,
            binned_ordinals=ds.binned_ordinals,
            cont_ordinals=ds.cont_ordinals, valid_rows=valid)

    def shard_batch(self, codes, labels, cont) -> list:
        """Array-level staging, the fold's entry: host arrays are padded to
        the shard target and split over the data devices (placed whole on
        a one-device mesh); staged arrays pass through.  A global plan
        stages per process: the target covers the fleet (the same on every
        process), and this process keeps its own contiguous row block of
        the padded chunk (``process_local_batch``'s recipe)."""
        from avenir_tpu_torch.parallel.mesh import maybe_shard_batch, pad_batch

        if not _staged(codes):
            codes, labels, cont = pad_batch(self.pad_target(codes.shape[0]),
                                            codes, labels, cont)
            if self.is_global:
                per = codes.shape[0] // self.num_procs
                lo = self.proc_index * per
                codes, labels, cont = (None if a is None else a[lo:lo + per]
                                       for a in (codes, labels, cont))
        return maybe_shard_batch(self.mesh, codes, labels, cont,
                                 data_axis=self.data_axis)

    # -- telemetry ------------------------------------------------------------
    def announce(self, tracer=None) -> dict:
        """Journal the run's hardware identity once per journal
        (``shard.topology``: devices fleet-wide, device kind, mesh shape,
        axis names, process count) and return it.  Several seams announce
        (the fused scan, the stream job); the journal keeps one per
        topology.  A fleet worker also journals its join here
        (``fleet.join``, recorded before any journal existed)."""
        topo = {
            "devices": self.total_devices,
            "device_kind": self.device_kind(),
            "mesh": self.mesh.sizes,
            "axes": list(self.mesh.axis_names),
            "procs": self.num_procs,
        }
        if tracer is None:
            from avenir_tpu_torch.telemetry import spans as tel

            tracer = tel.tracer()
        tracer.event_once("shard.topology", self.g_suffix, **topo)
        from avenir_tpu_torch.parallel import mesh as pmesh

        join = pmesh.last_join()
        if join is not None:
            pmesh.journal_fleet_join(**join)
        return topo


def _staged(x) -> bool:
    """Is a chunk array on its device(s) already — split over a mesh, or
    whole on a one-device mesh?"""
    import torch

    from avenir_tpu_torch.parallel.mesh import Blocks

    return isinstance(x, (Blocks, torch.Tensor))

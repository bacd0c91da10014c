"""One process of a port fleet for tests/test_torch_multiprocess.py.

``python tests/torch_fleet_worker.py <store> <rank> <nprocs> <workdir>
<specs.json>`` joins the fleet through ``init_distributed`` with torch's
``init_method=file://<store>`` (a ``FileStore`` rendezvous: no port is
picked or handed on; only gloo's own listeners bind, on port 0), then
runs each spec of the JSON list in order, on the CPU, as a user would:

- ``{"job": name, "input": path, "out": dir, "conf": {...}}`` —
  ``get_job(name).run``; ``"expect_crash": true`` expects the injected
  fault to fire on this process;
- ``{"pipeline": {...props...}, "workspace": dir}`` — a conf-declared
  pipeline;
- ``{"sum": case}`` — ``all_process_sum_state`` on this rank's part of
  the case, saved to ``<workdir>/sum_<case>_n<nprocs>_p<rank>.npz`` (or
  the error);
- ``{"mesh": true}`` — the hybrid mesh and a process-local batch;
- ``{"qstep": true}`` — the global plan's quantized chunk step
  (``shard.devices=2``, ``shard.proc.axis=proc``,
  ``shard.allreduce.quantized``) on :func:`gram_rows`' 2000 rows, the
  gram saved to ``<workdir>/qstep_p<rank>.npz``;
- ``{"gram": device}`` — this rank's block of :func:`gram_rows` counted
  by ``hist.cooc_counts`` on ``device`` (B1 on ``cuda``), the partials
  summed by ``all_process_sum_state`` into ``<workdir>/gram_p<rank>.npz``.

Prints ``proc <rank> spec <i> ok|crashed|error: ...`` per spec and
``proc <rank> done`` at the end.  Imports nothing of JAX.
"""

import json
import os
import sys

import numpy as np


def sum_case(case: str, rank: int) -> dict:
    """This rank's contribution to a named ``all_process_sum_state`` case
    (the test folds the same parts itself)."""
    if case == "mixed":
        out = {"common": np.array([2 ** 31 - 1 + rank, -rank], np.int64),
               f"only{rank}": np.arange(3, dtype=np.int64) * (rank + 1),
               "min:m": np.array([rank, -rank, 7], np.int64),
               "max:m": np.array([rank, -rank, 7], np.int64),
               "f": np.array([0.1 * (rank + 1), 1e16 if rank == 0 else 1.0,
                              1.0 / 3.0 ** rank], np.float64)}
        if rank == 2:
            out.pop("common")                 # a key this rank lacks
        return out
    if case == "empty":
        return {} if rank else {"x": np.ones((2, 2), np.float32)}
    if case == "shape":
        return {"bad": np.zeros(3 if rank == 1 else 2, np.int64)}
    raise ValueError(case)


def gram_rows(n: int = 5000, f: int = 10, b: int = 13, c: int = 2):
    """Seeded hospital-shaped codes [N, F] and labels [N] (int32)."""
    rng = np.random.default_rng(11)
    return (rng.integers(0, b, (n, f)).astype(np.int32),
            rng.integers(0, c, n).astype(np.int32))


def main() -> None:
    store, rank, nprocs, workdir, specs_file = sys.argv[1:6]
    rank, nprocs = int(rank), int(nprocs)
    from avenir_tpu_torch.parallel.mesh import init_distributed

    assert init_distributed(init_method=f"file://{store}",
                            num_processes=nprocs, process_id=rank,
                            timeout_s=120) == rank
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.jobs import get_job
    from avenir_tpu_torch.parallel import mesh as pmesh
    from avenir_tpu_torch.pipeline import driver

    # the test writes the specs file before any rank starts and nothing
    # writes it after, so every rank reads the same bytes
    # graftlint: disable=GL001
    with open(os.path.join(workdir, specs_file)) as fh:
        specs = json.load(fh)
    for i, spec in enumerate(specs):
        try:
            if "job" in spec:
                counters = get_job(spec["job"]).run(
                    JobConfig(dict(spec["conf"])),
                    os.path.join(workdir, spec["input"]),
                    os.path.join(workdir, spec["out"]), device="cpu")
                rows = counters.get("Records", "Processed")
                print(f"proc {rank} spec {i} rows={rows}", flush=True)
            elif "pipeline" in spec:
                driver.Pipeline.from_conf(
                    JobConfig(dict(spec["pipeline"])),
                    workspace=os.path.join(workdir, spec["workspace"]),
                    device="cpu").run()
            elif "sum" in spec:
                try:
                    out = pmesh.all_process_sum_state(
                        sum_case(spec["sum"], rank))
                except ValueError as e:
                    out = {"error": np.array(str(e))}
                np.savez(os.path.join(
                    workdir, f"sum_{spec['sum']}_n{nprocs}_p{rank}.npz"),
                    **out)
            elif "mesh" in spec:
                m = pmesh.make_hybrid_mesh(device="cpu")
                b = pmesh.process_local_batch(
                    m, np.arange(10, dtype=np.int32) + 100 * rank,
                    data_axis="model")
                print(f"proc {rank} mesh {json.dumps(m.sizes)} "
                      f"labels {m.axis_labels('model')[:2]} "
                      # one spec per iteration, on CPU tensors: nothing to sync
                      # graftlint: disable=GL005
                      f"rows {[p.tolist() for p in b.parts][:2]}",
                      flush=True)
            elif "qstep" in spec:
                from avenir_tpu_torch.parallel import collectives
                from avenir_tpu_torch.parallel.shard import ShardSpec

                plan = ShardSpec.from_conf(JobConfig({
                    "shard.devices": "2", "shard.proc.axis": "proc",
                    "shard.allreduce.quantized": "true"}), "cpu")
                codes, labels = gram_rows(n=2000, f=6, b=2)
                staged = plan.shard_batch(codes, labels, None)
                step = collectives.sharded_scan_step(
                    plan.mesh, 2, 2, data_axis=plan.data_axis,
                    quantized=True, moments=False, proc_axis=plan.proc_axis)
                g, _ = step(staged[0], staged[1], None)
                np.savez(os.path.join(workdir, f"qstep_p{rank}.npz"),
                         # one spec per iteration, on CPU tensors: nothing to sync
                         # graftlint: disable=GL005
                         g=g.numpy())
            elif "gram" in spec:
                import torch

                from avenir_tpu_torch.ops import hist

                codes, labels = gram_rows()
                lo = rank * len(labels) // nprocs
                hi = (rank + 1) * len(labels) // nprocs
                g = hist.cooc_counts(
                    torch.from_numpy(codes[lo:hi]).to(spec["gram"]),
                    torch.from_numpy(labels[lo:hi]).to(spec["gram"]), 13, 2)
                out = pmesh.all_process_sum_state(
                    # one spec per iteration: the rank's gram enters the sum once
                    # graftlint: disable=GL005
                    {"g": g.cpu().numpy().astype(np.int64)})
                np.savez(os.path.join(workdir, f"gram_p{rank}.npz"), **out)
        except Exception as e:  # noqa: BLE001
            if spec.get("expect_crash") and "injected" in str(e):
                print(f"proc {rank} spec {i} crashed", flush=True)
                continue
            print(f"proc {rank} spec {i} error: {type(e).__name__}: {e}",
                  flush=True)
            raise
        print(f"proc {rank} spec {i} ok", flush=True)
    print(f"proc {rank} done", flush=True)


if __name__ == "__main__":
    main()

"""The CSV configuration's unit of work: one run of the conf-declared NB
+ MI pipeline over CSV part files, ``Pipeline.from_conf(conf,
device).run()`` in-process, as ``python -m avenir_tpu_torch.pipeline run
job.properties`` runs it: the driver fuses the two stages into one
``SharedScan`` over the job's chunk stream (the line reader, the native
encoder, the ``DeviceFeeder``), and each stage writes its part file.

Traffic parameters: ``rows`` (rows a job), ``part_rows``,
``pool_parts``, ``parts_per_job`` and ``chunk_rows``.  At set-up the pool
of ``pool_parts`` part files is written (``generator.py``) to memory
files of this process (:func:`memory_file`): RAM-backed on every host,
seen by no other process, and freed however the process ends.  The
schema, ``job.properties``, each job's input directory (symlinks to its
``parts_per_job`` distinct parts) and its output workspace lie in a
directory under ``TMPDIR``.  The sets come in rounds: a round is a seeded
partition of the pool into sets, so every part is read in turn, and a
set already read is never drawn again (:func:`job_sets`), so no job's
answer can stand in for another's.  After the window every job's written
files are read back and held to the reference's tables for its own
parts.  The directory is removed at process exit, and on ``SIGTERM``.
"""

from __future__ import annotations

import atexit
import json
import os
import random
import shutil
import signal
import tempfile
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import torch

from . import compare, generator, reference

# the benchmark's own threads, rendering the pool at set-up and parsing it
# for the check (NumPy, which frees the interpreter lock); the program
# under test runs on the configuration's host_threads
THREADS = min(8, os.cpu_count() or 1)


def job_sets(seed: int, parts: int, per_job: int, jobs: int
             ) -> List[tuple]:
    """The part sets of the first ``jobs`` jobs: rounds of a seeded
    partition of the ``parts`` parts into sets of ``per_job``, each round
    redrawn until none of its sets was drawn before (the memory starts
    afresh once no round can be found)."""
    if parts % per_job:
        raise ValueError("pool_parts is a multiple of parts_per_job")
    rng = random.Random(seed)
    seen: set = set()
    out: List[tuple] = []
    while len(out) < jobs:
        for _ in range(100_000):
            order = list(range(parts))
            rng.shuffle(order)
            round_ = [tuple(sorted(order[i:i + per_job]))
                      for i in range(0, parts, per_job)]
            if not seen & set(round_):
                break
        else:
            seen.clear()
        seen.update(round_)
        out.extend(round_)
    return out[:jobs]


def memory_file(name: str) -> tuple:
    """A new, empty file in this process's memory (``memfd_create``),
    named ``name``: its descriptor, and a path that opens it, through
    ``/proc``.  Its pages are freed once the descriptor is closed, and
    when the process ends, by any signal."""
    fd = os.memfd_create(name)
    return fd, f"/proc/{os.getpid()}/fd/{fd}"


def _close(fds: List[int]) -> None:
    for fd in fds:
        os.close(fd)


_REMOVE: List[str] = []         # directories to remove on SIGTERM


def remove_on_exit(path: str) -> None:
    """Remove ``path`` at process exit, and on ``SIGTERM`` where no
    handler of the process's own takes it (then die by the signal)."""
    atexit.register(shutil.rmtree, path, ignore_errors=True)
    _REMOVE.append(path)
    if threading.current_thread() is threading.main_thread() \
            and signal.getsignal(signal.SIGTERM) is signal.SIG_DFL:
        signal.signal(signal.SIGTERM, _on_term)


def _on_term(signum, _frame):
    for path in _REMOVE:
        shutil.rmtree(path, ignore_errors=True)
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)


class Workload:
    items = "rows"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.schema = config["schema"]
        self.props = dict(config["properties"])
        self.laplace = float(config["laplace"])
        self.rows = int(traffic["rows"])
        self.part_rows = int(traffic["part_rows"])
        self.pool = int(traffic["pool_parts"])
        self.per_job = int(traffic["parts_per_job"])
        self.chunk_rows = int(traffic["chunk_rows"])
        if self.rows != self.part_rows * self.per_job:
            raise ValueError("rows is part_rows x parts_per_job")
        self.props["stream.chunk.rows"] = str(self.chunk_rows)
        self.seed = seed
        self.device = torch.device(device)
        self._sets: List[tuple] = []
        self.done: List[tuple] = []     # (parts, the job's workspace)

    def shape(self) -> Dict[str, object]:
        return {"chunk_rows": self.chunk_rows,
                "n_bins": reference.n_bins(self.schema),
                "num_classes": len(reference.class_field(
                    self.schema)["cardinality"])}

    def parts_of(self, index: int) -> tuple:
        """The parts of the window's job ``index`` (the warm-up job at
        set-up is index -1)."""
        while len(self._sets) <= index + 1:
            self._sets = job_sets(self.seed, self.pool, self.per_job,
                                  2 * len(self._sets) + 16)
        return self._sets[index + 1]

    def make_inputs(self) -> None:
        """The pool of part files, the schema and the properties file."""
        self.root = tempfile.mkdtemp(prefix="cardbench-csv-")
        remove_on_exit(self.root)
        fds, self.paths = zip(*(memory_file(f"part-{p:05d}")
                                for p in range(self.pool)))
        weakref.finalize(self, _close, fds)
        generator.write_pool(self.paths, self.schema, self.seed,
                             self.part_rows, self.device, THREADS)
        schema_path = os.path.join(self.root, "hosp_readmit.json")
        with open(schema_path, "w") as fh:
            json.dump(self.schema, fh)
        self.props["feature.schema.file.path"] = schema_path
        self.conf_path = os.path.join(self.root, "job.properties")
        with open(self.conf_path, "w") as fh:
            fh.writelines(f"{k}={v}\n" for k, v in sorted(self.props.items()))

    def setup(self) -> None:
        self._job(-1)               # builds the kernels, warms every shape

    def _job(self, index: int) -> str:
        """Run job ``index`` over its own parts; its workspace."""
        from avenir_tpu_torch.core.config import JobConfig
        from avenir_tpu_torch.pipeline.driver import Pipeline

        name = f"job{index}" if index >= 0 else "warm"
        data = os.path.join(self.root, "in", name)
        os.makedirs(data)
        for p in self.parts_of(index):
            os.symlink(self.paths[p], os.path.join(data, f"part-{p:05d}"))
        ws = os.path.join(self.root, "out", name)
        conf = JobConfig.from_file(self.conf_path)
        conf.set("pipeline.bind.data", data)
        conf.set("pipeline.workspace", ws)
        Pipeline.from_conf(conf, device=self.device).run()
        return ws

    def unit(self, index: int) -> int:
        ws = self._job(index)
        self.done.append((self.parts_of(index), ws))
        return self.rows

    def release(self) -> None:
        """Nothing of the program outlives its job; the part files and
        the written outputs stay for the check."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _part_tables(self, parts) -> Dict[int, dict]:
        """Each part's tables, the parts parsed side by side."""
        parts = sorted(parts)
        with ThreadPoolExecutor(THREADS) as pool:
            tables = pool.map(lambda p: reference.part_tables(
                self.paths[p], self.schema, self.device), parts)
            return dict(zip(parts, tables))

    def check(self) -> Dict[str, float]:
        tables = self._part_tables({p for parts, _ in self.done
                                    for p in parts})

        def gaps(parts, ws):
            ref = reference.from_tables(
                reference.job_tables([tables[p] for p in parts]),
                self.schema, self.laplace)
            files = {s: compare.read_part(os.path.join(ws, s))
                     for s in ("bayes", "mi")}
            return compare.job_gaps(files, ref, self.schema)

        return compare.worst(gaps(parts, ws) for parts, ws in self.done)

    def control(self) -> Dict[str, float]:
        """The control's readings (after :meth:`make_inputs`): the
        reference one precision step down, written as the program writes
        its files, over the parts of the window's first job."""
        parts = self.parts_of(0)
        tables = self._part_tables(parts)
        ref = reference.from_tables(
            reference.job_tables([tables[p] for p in parts]), self.schema,
            self.laplace)
        files = reference.control_lines([tables[p] for p in parts],
                                        self.schema)
        return compare.job_gaps(files, ref, self.schema)

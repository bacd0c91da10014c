"""The process-scoped snapshot directory of a fleet — the one place its
``proc-NNN-of-NNN`` name is made and recognised.

Each process of a fleet owns its slice of the stream, so its snapshots
live in ``<dir>/proc-NNN-of-NNN/``.  The name pins the process count: a
relaunch at another count finds no snapshot and starts from zero, never
double-counting.  The width is fixed at three digits, so lexicographic
order is numeric order.
"""

from __future__ import annotations

import os
import re

from avenir_tpu_torch.core.config import ConfigError

_PROC_DIR = re.compile(r"proc-\d+-of-\d+")


def proc_subdir(directory: str) -> str:
    """``directory`` in one process; in a fleet, this process's
    ``<directory>/proc-NNN-of-NNN``.  Refuses a fleet of 1000 processes
    or more, whose index would not fit the name's width."""
    from avenir_tpu_torch.parallel.mesh import process_grid

    pid, nprocs = process_grid()
    if nprocs == 1:
        return directory
    if nprocs >= 10 ** 3:
        raise ConfigError(
            f"{nprocs} processes exceeds the proc-NNN-of-NNN 3-digit "
            f"checkpoint-subdirectory width")
    return os.path.join(directory, f"proc-{pid:03d}-of-{nprocs:03d}")


def is_proc_subdir(name: str) -> bool:
    """Is ``name`` a process-scoped snapshot directory's name?"""
    return _PROC_DIR.fullmatch(name) is not None

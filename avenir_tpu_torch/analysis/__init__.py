"""graftlint for the PyTorch port — AST-based hazard analysis of
``avenir_tpu_torch/`` and ``chip_smoke.py``.

The counterpart of ``avenir_tpu/analysis`` (the same engine, suppressions,
baseline, registries and rule ids), pointed at the port's own sources: a
process-divergent value flowing into a ``torch.distributed`` collective
(GL001), checkpoint state that doesn't fingerprint its configuration
(GL002), fixed-width format keys that silently mis-sort past their width
(GL003), config keys that exist in code but not in ``docs/`` (GL004),
per-iteration host syncs on tensors (GL005), I/O under a held lock
(GL006), journal-event and counter drift (GL007, GL008), thread targets
without exception routing (GL009), bare errors on conf-contract paths
(GL010), once-per-run events without the latch (GL011) and silently
swallowed excepts (GL012).

Usage::

    python -m avenir_tpu_torch.analysis [paths...]        # lint (default tree)
    python -m avenir_tpu_torch.analysis --json ...        # machine-readable
    python -m avenir_tpu_torch.analysis --write-baseline  # grandfather findings
    python -m avenir_tpu_torch.analysis --write-registry  # regen registries

Per-line suppression: ``# graftlint: disable=GL005`` (same line, or alone
on the line above) with a comment saying why.  Grandfathered findings live
in ``avenir_tpu_torch/analysis/baseline.json`` with a ``why`` per entry.

Pure stdlib — importing this package pulls in neither torch nor jax nor
anything of ``avenir_tpu`` (the gate runs before any device work).
"""

from avenir_tpu_torch.analysis.engine import Finding, run_paths  # noqa: F401
from avenir_tpu_torch.analysis.rules import RULES  # noqa: F401

__all__ = ["Finding", "run_paths", "RULES"]

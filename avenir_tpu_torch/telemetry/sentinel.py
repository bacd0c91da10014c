"""Perf-regression sentinel — the consumer the BENCH_r*.json trajectory
never had.

Every round publishes bench artifacts, and until now a regression like
the r05 ``families.tree`` 0.21× row was only caught when a human reread
BASELINE.md.  This module turns the trajectory into an automated gate:

    python -m avenir_tpu_torch.telemetry regress BENCH_new.json \
        --baseline BENCH_prev.json [--tolerance-pct 25] \
        [--tolerance families.tree=40]

compares the canary-conditioned metrics of a capture against a baseline
artifact within per-metric tolerance bands and exits 0 (pass) / 1
(regression) / 3 (skip: every comparable metric was canary-flagged).
``bench.py`` runs :func:`bench_verdict` in-process at the end of a
capture, so every future artifact carries its own verdict and journals a
``bench.regression`` event when tracing is on.

Canary conditioning (the BASELINE.md interpretation contract, reused —
never reimplemented): a metric whose capture is canary-flagged — its
``value_canary_clean`` is null (no rig-clean pass) or its fresh matmul
canary exceeds the healthy threshold — is **skipped with a verdict**,
not compared: a contended rig indicts the rig, and comparing its numbers
would either mask a real regression or invent one.

All metrics here are rates (higher is better); a regression is
``value < baseline * (1 - tolerance_pct/100)``.  Stdlib-only.
"""

from __future__ import annotations

import fnmatch
import json
from typing import Dict, List, Optional

# the BASELINE.md interpretation contract: matmul canary ≲ 7 ms reads
# healthy; the contended regime reads 10-100x higher (bench.py uses the
# same bound for value_canary_clean)
CANARY_HEALTHY_MS = 7.0

DEFAULT_TOLERANCE_PCT = 25.0

EXIT_PASS = 0
EXIT_REGRESSION = 1
EXIT_SKIP = 3


def _line(artifact: dict) -> dict:
    """Unwrap a driver capture (``{"parsed": {...}}``) to the bench line."""
    if isinstance(artifact, dict) and isinstance(artifact.get("parsed"),
                                                 dict):
        return artifact["parsed"]
    return artifact if isinstance(artifact, dict) else {}


def _canary_flagged(row: dict) -> bool:
    """A row is rig-flagged when its fresh matmul canary (scalar form —
    knn, the primary) exceeds the healthy bound, or when it carries a
    per-pass canary list (family_bench rows) with NO rig-clean pass."""
    canary = row.get("canary_matmul_4096_bf16_ms")
    if isinstance(canary, (int, float)) and canary > CANARY_HEALTHY_MS:
        return True
    per_pass = row.get("canary_per_pass_ms")
    if isinstance(per_pass, (list, tuple)) and per_pass:
        readings = [c for c in per_pass if isinstance(c, (int, float))]
        return bool(readings) and min(readings) > CANARY_HEALTHY_MS
    return False


def _row_entry(row: dict) -> Optional[dict]:
    """One comparable row honoring the ``value_canary_clean`` convention
    (field present → IT is the value, null → flagged; absent → raw value
    conditioned on the row's own canary readings).  None = no row."""
    flagged = False
    value = row.get("value")
    if "value_canary_clean" in row:
        value = row.get("value_canary_clean")
        flagged = value is None
    elif _canary_flagged(row):
        flagged = True
    if isinstance(value, (int, float)) or flagged:
        return {"value": value, "unit": row.get("unit"),
                "canary_flagged": flagged}
    return None


def extract_metrics(artifact: dict) -> Dict[str, dict]:
    """``{metric name: {value, unit, canary_flagged}}`` from a bench line
    (or driver wrapper).  The primary metric honors the
    ``value_canary_clean`` convention: when the field exists, IT is the
    comparable value and null means canary-flagged; older artifacts
    (pre-round-7) fall back to the raw value conditioned on the pre-run
    canary.  Rows without a numeric value are omitted."""
    line = _line(artifact)
    out: Dict[str, dict] = {}
    if not isinstance(line.get("metric"), str):
        return out

    entry = _row_entry(line)
    if entry is not None:
        out[line["metric"]] = entry

    knn = line.get("knn")
    if isinstance(knn, dict) and isinstance(knn.get("value"), (int, float)):
        out["knn"] = {"value": knn["value"], "unit": knn.get("unit"),
                      "canary_flagged": _canary_flagged(knn)}

    families = line.get("families")
    if isinstance(families, dict):
        for fam in sorted(families):
            row = families[fam]
            if isinstance(row, dict) and isinstance(row.get("value"),
                                                    (int, float)):
                out[f"families.{fam}"] = {
                    "value": row["value"], "unit": row.get("unit"),
                    "canary_flagged": _canary_flagged(row)}

    # PackGraft: the wide_schema --path pack sweep publishes a
    # nested "packed" block — per-row dicts keyed by sub-metric name,
    # each honoring the same value_canary_clean/per-pass conventions as
    # the primary (pack_speedup carries no canary fields by design: both
    # sides of the ratio share the rig, so contention divides out)
    packed = line.get("packed")
    if isinstance(packed, dict):
        for name in sorted(packed):
            row = packed[name]
            if isinstance(row, dict):
                entry = _row_entry(row)
                if entry is not None:
                    out[f"packed.{name}"] = entry

    # PlanGraft: the e2e bench's planned-vs-staged section
    # publishes a nested "planned" block the same way — plan_speedup is
    # the banded row (a shared-rig ratio, so no canary fields, exactly
    # like pack_speedup); scan-second rows ride the conventions above
    planned = line.get("planned")
    if isinstance(planned, dict):
        for name in sorted(planned):
            row = planned[name]
            if isinstance(row, dict):
                entry = _row_entry(row)
                if entry is not None:
                    out[f"planned.{name}"] = entry
    return out


def evaluate(current: dict, baseline: dict,
             tolerance_pct: float = DEFAULT_TOLERANCE_PCT,
             per_metric: Optional[Dict[str, float]] = None) -> dict:
    """Compare a capture against a baseline artifact.

    Returns ``{"verdict", "compared", "regressed", "skipped", "missing",
    "rows"}`` where verdict is ``pass`` / ``regression`` / ``skip``
    (nothing comparable survived canary conditioning) / ``no_baseline``
    (the baseline carries no comparable metrics — e.g. a bands-less
    BASELINE.json).  Per-row verdicts: ``pass``, ``regression``,
    ``skipped_canary`` (either side flagged), ``no_baseline``,
    ``skipped_optional``, and ``missing`` — a metric the baseline gates
    but the capture no longer emits, which fails the gate like a
    regression (a capture that silently stops producing a gated row must
    not pass by omission).  The baseline may declare
    ``{"sentinel": {"optional": ["packed.*", ...]}}`` glob patterns:
    bands for rows only SOME benchmarks emit (the packed sweep's) — an
    absent optional row is ``skipped_optional`` instead of failing every
    capture from a benchmark that never produces it, but it IS still
    compared whenever present."""
    cur = extract_metrics(current)
    base = extract_metrics(baseline)
    per_metric = per_metric or {}
    gates = _line(baseline).get("sentinel")
    optional = (gates.get("optional", [])
                if isinstance(gates, dict) else [])
    rows: List[dict] = []
    regressed: List[str] = []
    skipped: List[str] = []
    missing: List[str] = []
    compared = 0
    for name in base:
        if name not in cur:
            if any(fnmatch.fnmatch(name, pat) for pat in optional
                   if isinstance(pat, str)):
                skipped.append(name)
                rows.append({"metric": name, "value": None,
                             "baseline": base[name]["value"],
                             "tolerance_pct": None, "ratio": None,
                             "verdict": "skipped_optional"})
                continue
            missing.append(name)
            rows.append({"metric": name, "value": None,
                         "baseline": base[name]["value"],
                         "tolerance_pct": None, "ratio": None,
                         "verdict": "missing"})
    for name, m in cur.items():
        b = base.get(name)
        tol = float(per_metric.get(name, tolerance_pct))
        row = {"metric": name, "value": m["value"],
               "baseline": b["value"] if b else None,
               "tolerance_pct": tol, "ratio": None}
        if m["canary_flagged"] or (b is not None and b["canary_flagged"]):
            row["verdict"] = "skipped_canary"
            skipped.append(name)
        elif b is None or not isinstance(b["value"], (int, float)) \
                or b["value"] <= 0:
            row["verdict"] = "no_baseline"
        else:
            compared += 1
            row["ratio"] = round(m["value"] / b["value"], 4)
            if m["value"] < b["value"] * (1.0 - tol / 100.0):
                row["verdict"] = "regression"
                regressed.append(name)
            else:
                row["verdict"] = "pass"
        rows.append(row)
    if regressed or missing:
        verdict = "regression"
    elif compared:
        verdict = "pass"
    elif skipped:
        verdict = "skip"
    else:
        verdict = "no_baseline"
    return {"verdict": verdict, "compared": compared, "regressed": regressed,
            "skipped": skipped, "missing": missing, "rows": rows}


def journal_verdict(summary: dict, baseline_name: str) -> None:
    """Journal a golden-schema'd ``bench.regression`` event (no-op with
    tracing off)."""
    from avenir_tpu_torch.telemetry import spans as tel

    tel.tracer().event("bench.regression", verdict=summary["verdict"],
                       compared=summary["compared"],
                       regressed=summary["regressed"],
                       skipped=summary["skipped"],
                       missing=summary.get("missing", []),
                       baseline=baseline_name)


def bench_verdict(line: dict, baseline_path: str,
                  tolerance_pct: float = DEFAULT_TOLERANCE_PCT) -> dict:
    """The in-process gate bench.py embeds in its artifact: evaluate
    ``line`` against the artifact at ``baseline_path`` (missing/unreadable
    baseline → a ``no_baseline`` verdict, never an exception — the capture
    must publish either way) and journal the verdict."""
    try:
        with open(baseline_path, encoding="utf-8") as fh:
            baseline = json.load(fh)
    except (OSError, ValueError):
        summary = {"verdict": "no_baseline", "compared": 0, "regressed": [],
                   "skipped": [], "missing": [], "rows": []}
        journal_verdict(summary, baseline_path)
        return {"verdict": "no_baseline", "baseline": baseline_path,
                "compared": 0, "regressed": [], "skipped": [],
                "missing": []}
    summary = evaluate(line, baseline, tolerance_pct=tolerance_pct)
    journal_verdict(summary, baseline_path)
    return {"verdict": summary["verdict"], "baseline": baseline_path,
            "compared": summary["compared"],
            "regressed": summary["regressed"],
            "skipped": summary["skipped"],
            "missing": summary["missing"]}


def exit_code(verdict: str) -> int:
    if verdict == "regression":
        return EXIT_REGRESSION
    if verdict == "skip":
        return EXIT_SKIP
    return EXIT_PASS


def cli(argv: List[str]) -> int:
    """``python -m avenir_tpu_torch.telemetry regress <bench.json...>
    --baseline <artifact>`` — prints one verdict line per metric plus a
    JSON summary, exits 0/1/3 (pass/regression/all-skipped)."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m avenir_tpu_torch.telemetry regress",
        description="Gate bench captures against a baseline artifact")
    ap.add_argument("artifacts", nargs="+", help="bench JSON capture(s)")
    ap.add_argument("--baseline", required=True,
                    help="baseline bench JSON artifact")
    ap.add_argument("--tolerance-pct", type=float,
                    default=DEFAULT_TOLERANCE_PCT,
                    help="allowed drop below baseline (default 25)")
    ap.add_argument("--tolerance", action="append", default=[],
                    metavar="METRIC=PCT",
                    help="per-metric tolerance override (repeatable)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the full summary as JSON")
    args = ap.parse_args(argv)
    per_metric: Dict[str, float] = {}
    for spec in args.tolerance:
        name, _, pct = spec.partition("=")
        try:
            per_metric[name] = float(pct)
        except ValueError:
            # a usage error must exit 2, never masquerade as exit 1
            # (the REGRESSION code a CI gate acts on); catches both a
            # missing '=' (empty pct) and a non-numeric pct
            print(f"--tolerance expects METRIC=PCT, got {spec!r}",
                  file=sys.stderr)
            return 2
    try:
        with open(args.baseline, encoding="utf-8") as fh:
            baseline = json.load(fh)
    except (OSError, ValueError) as exc:
        print(f"cannot read baseline: {exc}", file=sys.stderr)
        return 2
    worst = "no_baseline"
    rank = {"no_baseline": 0, "pass": 1, "skip": 2, "regression": 3}
    summaries = []
    for path in args.artifacts:
        try:
            with open(path, encoding="utf-8") as fh:
                current = json.load(fh)
        except (OSError, ValueError) as exc:
            print(f"cannot read artifact: {exc}", file=sys.stderr)
            return 2
        summary = evaluate(current, baseline,
                           tolerance_pct=args.tolerance_pct,
                           per_metric=per_metric)
        summary["artifact"] = path
        summaries.append(summary)
        if rank[summary["verdict"]] > rank[worst]:
            worst = summary["verdict"]
        if not args.as_json:
            print(f"{path}: {summary['verdict'].upper()} "
                  f"(compared={summary['compared']} "
                  f"regressed={len(summary['regressed'])} "
                  f"skipped={len(summary['skipped'])} "
                  f"missing={len(summary['missing'])})")
            for row in summary["rows"]:
                ratio = ("-" if row["ratio"] is None
                         else f"{row['ratio']:.3f}x")
                tol = ("-" if row["tolerance_pct"] is None
                       else f"{row['tolerance_pct']:g}%")
                print(f"  {row['verdict']:>15}  {row['metric']:<32} "
                      f"{row['value']} vs {row['baseline']}  {ratio} "
                      f"(tol {tol})")
    if args.as_json:
        print(json.dumps(summaries))
    return exit_code(worst)

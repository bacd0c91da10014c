"""graftlint CLI — ``python -m avenir_tpu_torch.analysis [paths...]``.

Emits ``file:line: RULE message`` per finding (or a JSON array with
``--json``) and exits non-zero when any non-baselined finding remains.
Run from the repo root (paths in the baseline and registries are
root-relative).  Stdlib-only: imports neither torch nor jax.

Incremental mode: ``--changed`` scopes the re-analysis to the files git
reports as modified and reuses the warm facts cache
(``.graftlint-torch-cache.json``, apart from the JAX package's so the
two analyzers never evict each other's cache) for everything else — the cross-file rules
still see the whole tree, so a warm run is well under a second.
``--stats`` prints files/rules/cache-hits/wall.  ``--check-registry``
fails when either generated registry (config keys, counter groups/span
sites) is stale.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional, Set

from avenir_tpu_torch.analysis import engine, registry_gen

DEFAULT_PATHS = ("avenir_tpu_torch", "chip_smoke.py")
DEFAULT_DOC_PATHS = ("docs", "README.md")
CACHE_PATH = ".graftlint-torch-cache.json"


def _git_changed(root: str) -> Optional[Set[str]]:
    """Root-relative paths with uncommitted changes (worktree or index),
    or None when git is unavailable — callers fall back to a full run."""
    try:
        proc = subprocess.run(
            ["git", "-C", root, "status", "--porcelain", "-uall"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    if proc.returncode != 0:
        return None
    changed: Set[str] = set()
    for line in proc.stdout.splitlines():
        p = line[3:].strip()
        if " -> " in p:
            p = p.split(" -> ")[-1]
        if p.startswith('"') and p.endswith('"'):
            p = p[1:-1]
        changed.add(p)
    return changed


def _check_registries(paths: List[str], doc_paths: List[str]) -> int:
    """Exit status 1 when a generated registry no longer matches what a
    fresh scan produces (the staleness gate)."""
    stale = []
    want_cfg = {
        key: registry_gen.scan_documented_keys(doc_paths).get(key)
        for key in registry_gen.scan_code_keys(paths)
    }
    try:
        from avenir_tpu_torch.analysis.config_registry import CONFIG_KEYS
        have_cfg = dict(CONFIG_KEYS)
    except ImportError:
        have_cfg = None
    if have_cfg != {k: (v.replace(os.sep, "/") if v else None)
                    for k, v in want_cfg.items()}:
        stale.append("config_registry.py")
    groups, spans = registry_gen.scan_counter_span_sites(paths)
    documented = registry_gen.scan_doc_tokens(doc_paths)
    want_groups = {g: documented.get(g) for g in sorted(groups)}
    want_spans = {s: documented.get(s) for s in sorted(spans)}
    try:
        from avenir_tpu_torch.analysis.counter_registry import (COUNTER_GROUPS,
                                                          SPAN_SITES)
        if dict(COUNTER_GROUPS) != want_groups or \
                dict(SPAN_SITES) != want_spans:
            stale.append("counter_registry.py")
    except ImportError:
        stale.append("counter_registry.py")
    if stale:
        print(f"stale registr{'y' if len(stale) == 1 else 'ies'}: "
              f"{', '.join(stale)} — regenerate with "
              f"`python -m avenir_tpu_torch.analysis --write-registry`",
              file=sys.stderr)
        return 1
    print("registries up to date")
    return 0


def main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m avenir_tpu_torch.analysis",
        description="graftlint for the PyTorch port — whole-program AST "
                    "hazard analysis (GL001–GL012)")
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to lint (default: "
                         f"{' '.join(DEFAULT_PATHS)} when present)")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as a JSON array")
    ap.add_argument("--baseline", default=engine.BASELINE_PATH,
                    help="baseline file (default: the checked-in one)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (show every finding)")
    ap.add_argument("--show-baselined", action="store_true",
                    help="also print grandfathered findings")
    ap.add_argument("--write-baseline", action="store_true",
                    help="grandfather all current findings (then fill in "
                         "each entry's 'why')")
    ap.add_argument("--write-registry", action="store_true",
                    help="regenerate analysis/config_registry.py and "
                         "analysis/counter_registry.py from the code + "
                         "docs trees")
    ap.add_argument("--check-registry", action="store_true",
                    help="fail when a generated registry is stale")
    ap.add_argument("--changed", action="store_true",
                    help="incremental: re-analyze only git-modified files, "
                         "reuse the facts cache for the rest (cross-file "
                         "rules still see the whole tree)")
    ap.add_argument("--stats", action="store_true",
                    help="print files/rules/cache-hits/wall to stderr")
    ap.add_argument("--no-cache", action="store_true",
                    help=f"skip the facts cache ({CACHE_PATH})")
    args = ap.parse_args(argv)

    paths = args.paths or [p for p in DEFAULT_PATHS if os.path.exists(p)]
    if not paths:
        ap.error("no paths given and none of the defaults exist "
                 f"({', '.join(DEFAULT_PATHS)}) — run from the repo root")
    doc_paths = [p for p in DEFAULT_DOC_PATHS if os.path.exists(p)]

    if args.write_registry:
        registry = registry_gen.write_registry(paths, doc_paths)
        undoc = sorted(k for k, v in registry.items() if v is None)
        print(f"wrote {registry_gen.REGISTRY_PATH}: "
              f"{len(registry)} keys, {len(undoc)} undocumented"
              + (f" ({', '.join(undoc)})" if undoc else ""))
        groups, spans = registry_gen.write_counter_registry(paths,
                                                            doc_paths)
        undoc2 = sorted(k for k, v in {**groups, **spans}.items()
                        if v is None)
        print(f"wrote {registry_gen.COUNTER_REGISTRY_PATH}: "
              f"{len(groups)} groups, {len(spans)} spans, "
              f"{len(undoc2)} undocumented"
              + (f" ({', '.join(undoc2)})" if undoc2 else ""))
        return 0

    if args.check_registry:
        return _check_registries(paths, doc_paths)

    baseline = None if args.no_baseline else args.baseline
    changed = _git_changed(os.getcwd()) if args.changed else None
    stats: dict = {}
    findings = engine.run_paths(
        paths, baseline_path=baseline,
        cache_path=None if args.no_cache else CACHE_PATH,
        changed=changed, stats=stats)

    if args.write_baseline:
        existing = engine.load_baseline(
            args.baseline if os.path.exists(args.baseline) else None)
        engine.write_baseline(args.baseline, findings, existing=existing)
        n_new = sum(1 for f in findings if not f.baselined)
        print(f"wrote {args.baseline}: {n_new} new entr"
              f"{'y' if n_new == 1 else 'ies'} (existing whys preserved) — "
              f"fill in each new 'why' before committing")
        return 0

    live = [f for f in findings if not f.baselined]
    shown = findings if args.show_baselined else live
    if args.json:
        print(json.dumps([f.as_dict() for f in shown], indent=2))
    else:
        for f in shown:
            print(f.format())
        n_base = sum(1 for f in findings if f.baselined)
        print(f"graftlint: {len(live)} finding(s), {n_base} baselined",
              file=sys.stderr)
    if args.stats:
        print(f"graftlint stats: {stats.get('files', 0)} files, "
              f"{stats.get('rules', 0)} rules, "
              f"{stats.get('cache_hits', 0)} cache hits, "
              f"{stats.get('wall_s', 0.0)}s", file=sys.stderr)
    return 1 if live else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

"""graftlint engine — whole-program pass, caching, suppressions, baseline.

The engine runs **two phases**:

1. **per-file** — each ``.py`` file is parsed once; the local rules
   (GL001–GL005, GL009–GL012 in rules.py) run on its tree and a
   JSON-serializable *facts* record is extracted (symbol table, import
   targets, call edges, lock regions, emit/counter/span sites —
   program.py).  Both outputs are content-hash-cached per file
   (``--changed`` additionally trusts git to skip re-reading unchanged
   files), so warm re-runs cost milliseconds.
2. **project** — a :class:`~avenir_tpu_torch.analysis.program.ProjectContext`
   aggregates every file's facts (symbol index, import graph, transitive
   I/O closure) and the cross-file rules run over it: GL006 (I/O
   reachable under a held lock), GL007 (event-schema drift, both
   directions), GL008 (counter/span registry drift).  This phase is
   always fresh — it is cheap dict work.

The two escape hatches apply to both phases, in order:

1. **suppression comments** — ``# graftlint: disable=GL001[,GL002]`` on the
   finding's line (or alone on the line directly above it) drops the
   finding at the source; the comment is expected to say why.
   ``# graftlint: disable-file=GL004`` anywhere in a file's first 20 lines
   disables a rule for the whole file.
2. **baseline** — ``baseline.json`` grandfathers known findings by
   ``(rule, path, message)`` (line numbers are deliberately excluded so
   unrelated edits don't churn the baseline); each entry carries a ``why``.

Everything here is stdlib-only: the lint gate must run (and fail fast)
without importing torch or touching a device.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")

_SUPPRESS_RE = re.compile(r"#\s*graftlint:\s*disable=([A-Z0-9, ]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*graftlint:\s*disable-file=([A-Z0-9, ]+)")


@dataclass(frozen=True)
class Finding:
    """One rule violation.  ``path`` is root-relative POSIX (stable across
    machines — the baseline and CI compare these)."""

    rule: str
    path: str
    line: int
    message: str
    baselined: bool = False

    @property
    def key(self) -> Tuple[str, str, str]:
        """Baseline identity: line number excluded so edits above a
        grandfathered finding don't invalidate its entry."""
        return (self.rule, self.path, self.message)

    def format(self) -> str:
        tag = " [baselined]" if self.baselined else ""
        return f"{self.path}:{self.line}: {self.rule} {self.message}{tag}"

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "baselined": self.baselined}


def _parse_rule_list(text: str) -> Set[str]:
    return {r.strip() for r in text.split(",") if r.strip()}


def suppressions(src: str) -> Tuple[Dict[int, Set[str]], Set[str]]:
    """(line → suppressed rules, file-wide suppressed rules).

    A ``disable=`` comment applies to its own line; when the line holds
    nothing but the comment it applies to the next line instead (the
    conventional place for a suppression with a why-comment above the
    flagged statement).  Findings anchor at the statement's first line, so
    multi-line calls take the comment on (or above) that first line.
    """
    per_line: Dict[int, Set[str]] = {}
    file_wide: Set[str] = set()
    lines = src.splitlines()
    for i, line in enumerate(lines, start=1):
        if i <= 20:
            mf = _SUPPRESS_FILE_RE.search(line)
            if mf:
                file_wide |= _parse_rule_list(mf.group(1))
                continue
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = _parse_rule_list(m.group(1))
        target = i + 1 if line.strip().startswith("#") else i
        per_line.setdefault(target, set()).update(rules)
    return per_line, file_wide


def _iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__"
                                     and not d.startswith("."))
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        yield os.path.join(dirpath, name)
        elif p.endswith(".py"):
            yield p


def load_baseline(path: Optional[str]) -> List[dict]:
    if path is None or not os.path.exists(path):
        return []
    with open(path) as fh:
        data = json.load(fh)
    entries = data.get("findings", [])
    for e in entries:
        if not e.get("why"):
            raise ValueError(
                f"baseline entry {e.get('rule')}:{e.get('path')} has no "
                f"'why' — every grandfathered finding must say why it is "
                f"acceptable (or be fixed instead)")
    return entries


def write_baseline(path: str, findings: Sequence[Finding],
                   existing: Sequence[dict] = ()) -> None:
    """Grandfather the current findings: existing entries that still match
    a finding keep their curated ``why`` (an entry whose finding was fixed
    is dropped — the whole-tree test enforces that staleness anyway); new
    non-baselined findings get stub ``why`` fields the author must fill in
    (load_baseline rejects empty ones)."""
    live_keys = {f.key for f in findings}
    kept = [e for e in existing
            if (e["rule"], e["path"], e["message"]) in live_keys]
    kept_keys = {(e["rule"], e["path"], e["message"]) for e in kept}
    fresh = [{"rule": f.rule, "path": f.path, "message": f.message,
              "why": "FILL ME IN — why is this finding acceptable?"}
             for f in sorted(findings, key=lambda f: (f.path, f.line))
             if f.key not in kept_keys]
    entries = sorted(kept + fresh, key=lambda e: (e["path"], e["rule"]))
    with open(path, "w") as fh:
        json.dump({"findings": entries}, fh, indent=2)
        fh.write("\n")


# ---------------------------------------------------------------------------
# the per-file phase (cacheable)
# ---------------------------------------------------------------------------

def _file_record(src: str, path: str, relpath: str, local_rules: dict,
                 config_keys: Optional[dict],
                 event_once: Optional[frozenset]) -> dict:
    """Everything the project phase needs from one file: local findings
    (suppressions already applied), program facts, and the suppression
    maps (project findings are filtered against them later).  Pure
    function of (src, rule set) — safe to cache by content hash."""
    from avenir_tpu_torch.analysis.program import extract_facts
    from avenir_tpu_torch.analysis.rules import RuleContext

    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return {"findings": [["GL000", e.lineno or 1,
                              f"file does not parse: {e.msg}"]],
                "facts": None, "suppress": {"lines": {}, "file": []}}
    per_line, file_wide = suppressions(src)
    ctx = RuleContext(src=src, relpath=relpath, config_keys=config_keys,
                      event_once=event_once)
    findings: List[list] = []
    for rule_id, rule_fn in local_rules.items():
        if rule_id in file_wide:
            continue
        for line, message in rule_fn(tree, ctx):
            if rule_id in per_line.get(line, ()):
                continue
            findings.append([rule_id, line, message])
    return {
        "findings": findings,
        "facts": extract_facts(tree, src, relpath),
        "suppress": {
            "lines": {str(k): sorted(v) for k, v in per_line.items()},
            "file": sorted(file_wide),
        },
    }


def lint_file(path: str, relpath: str, rules=None,
              config_keys: Optional[dict] = None) -> List[Finding]:
    """Local findings for one file, suppression comments applied (the
    single-file entry point; the cross-file rules need
    :func:`run_paths`)."""
    from avenir_tpu_torch.analysis.program import PROJECT_RULES
    from avenir_tpu_torch.analysis.rules import RULES

    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    local = {rid: fn for rid, fn in (rules or RULES).items()
             if rid not in PROJECT_RULES}
    rec = _file_record(src, path, relpath, local, config_keys, None)
    return [Finding(rule, relpath, line, message)
            for rule, line, message in rec["findings"]]


# ---------------------------------------------------------------------------
# the facts cache
# ---------------------------------------------------------------------------

def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def cache_salt(config_keys: Optional[dict] = None,
               event_once: Optional[frozenset] = None) -> str:
    """Hash of the analyzer's own sources + the golden event schema (+ any
    caller-supplied registries): editing a rule or the schema invalidates
    every cached record."""
    from avenir_tpu_torch.analysis.program import EVENT_SCHEMA_PATH

    h = hashlib.sha256()
    analysis_dir = os.path.dirname(__file__)
    sources = sorted(
        os.path.join(analysis_dir, n) for n in os.listdir(analysis_dir)
        if n.endswith(".py"))
    sources.append(EVENT_SCHEMA_PATH)
    for p in sources:
        if os.path.exists(p):
            with open(p, "rb") as fh:
                h.update(fh.read())
    h.update(repr(sorted(config_keys.items())).encode()
             if config_keys is not None else b"-")
    h.update(repr(sorted(event_once)).encode()
             if event_once is not None else b"-")
    return h.hexdigest()


def _load_cache(cache_path: Optional[str], salt: str) -> Dict[str, dict]:
    if cache_path is None or not os.path.exists(cache_path):
        return {}
    try:
        with open(cache_path) as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return {}
    if data.get("salt") != salt:
        return {}
    return data.get("files", {})


def _write_cache(cache_path: Optional[str], salt: str,
                 files: Dict[str, dict]) -> None:
    if cache_path is None:
        return
    tmp = cache_path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"salt": salt, "files": files}, fh)
    os.replace(tmp, cache_path)


# ---------------------------------------------------------------------------
# the whole-program run
# ---------------------------------------------------------------------------

def run_paths(paths: Sequence[str], root: Optional[str] = None,
              baseline_path: Optional[str] = BASELINE_PATH,
              rules=None, config_keys: Optional[dict] = None,
              event_schema=None, counter_registry: Optional[dict] = None,
              cache_path: Optional[str] = None,
              changed: Optional[Set[str]] = None,
              stats: Optional[dict] = None) -> List[Finding]:
    """Lint ``paths`` (files or directories); returns findings sorted by
    (path, line) with baselined ones flagged, not dropped — callers decide
    whether to show them (CI fails only on non-baselined findings).

    - ``rules``: restrict to these rule ids (a dict — local entries map to
      their check functions, project ids select the built-in project
      rules).  None = everything.
    - ``event_schema``/``counter_registry``: registry overrides for GL007/
      GL008 (tests); None loads the real ones.
    - ``cache_path``: JSON facts cache (content-hash keyed, salted with
      the analyzer sources); None disables caching.
    - ``changed``: root-relative paths whose content may differ from the
      cache — any OTHER cached file is reused without re-reading
      (``--changed``'s git-scoped warm path).
    - ``stats``: dict that receives {files, cache_hits, rules, wall_s}.
    """
    from avenir_tpu_torch.analysis import program
    from avenir_tpu_torch.analysis.rules import RULES

    t0 = time.monotonic()
    root = os.path.abspath(root or os.getcwd())
    baseline = {(e["rule"], e["path"], e["message"])
                for e in load_baseline(baseline_path)}

    local_rules = {rid: fn for rid, fn in (rules or RULES).items()
                   if rid not in program.PROJECT_RULES}
    project_rules = {rid: program.PROJECT_RULES[rid]
                     for rid in (rules or program.PROJECT_RULES)
                     if rid in program.PROJECT_RULES}

    if event_schema is None:
        event_schema = program.load_event_schema()
    if counter_registry is None:
        counter_registry = program.load_counter_registry()
    event_once = (frozenset(event_schema.once)
                  if event_schema is not None else frozenset())

    salt = cache_salt(config_keys, event_once)
    cache = _load_cache(cache_path, salt)
    records: Dict[str, dict] = {}
    hits = 0
    for path in _iter_py_files([os.fspath(p) for p in paths]):
        ap = os.path.abspath(path)
        rel = os.path.relpath(ap, root) if ap.startswith(root + os.sep) \
            else ap
        rel = rel.replace(os.sep, "/")
        entry = cache.get(rel)
        if entry is not None and changed is not None and \
                rel not in changed:
            records[rel] = entry["rec"]        # trust git: skip the read
            hits += 1
            continue
        with open(ap, encoding="utf-8") as fh:
            src = fh.read()
        sha = _sha(src.encode("utf-8"))
        if entry is not None and entry["sha"] == sha:
            records[rel] = entry["rec"]
            hits += 1
            continue
        rec = _file_record(src, ap, rel, local_rules, config_keys,
                           event_once)
        cache[rel] = {"sha": sha, "rec": rec}
        records[rel] = rec
    _write_cache(cache_path, salt, cache)

    findings: List[Finding] = []
    for rel, rec in records.items():
        for rule, line, message in rec["findings"]:
            findings.append(Finding(rule, rel, line, message))

    # project phase — always fresh over the aggregated facts
    if project_rules:
        ctx = program.ProjectContext(
            files={rel: rec["facts"] for rel, rec in records.items()
                   if rec["facts"] is not None},
            root=root, event_schema=event_schema,
            counter_registry=counter_registry)
        for rule_id, rule_fn in project_rules.items():
            for rel, line, message in rule_fn(ctx):
                sup = records.get(rel, {}).get(
                    "suppress", {"lines": {}, "file": []})
                if rule_id in sup["file"] or \
                        rule_id in sup["lines"].get(str(line), ()):
                    continue
                findings.append(Finding(rule_id, rel, line, message))

    # dedupe (two identical format specs on one line report once), then
    # flag baselined entries
    findings = [
        Finding(f.rule, f.path, f.line, f.message,
                baselined=f.key in baseline)
        for f in dict.fromkeys(findings)
    ]
    if stats is not None:
        stats.update({
            "files": len(records), "cache_hits": hits,
            "rules": len(local_rules) + len(project_rules),
            "wall_s": round(time.monotonic() - t0, 3),
        })
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))

"""Registry generators — the ground truth GL004 and GL008 lint against.

Scans the code tree for every ``conf.get*("literal")`` read (the same AST
extractor GL004 lints with, so the two can never disagree) and the docs
tree for every backtick-documented dotted key, then writes
``avenir_tpu_torch/analysis/config_registry.py`` mapping each code key to
the doc file that mentions it (or ``None`` when undocumented — which GL004
then fails).  The same discipline covers counter groups and span names:
``counter_registry.py`` is generated from the facts extractor GL008 lints
with (f-string groups normalize to ``Serving.*``,
docs written as ``Serving.<model>`` match).  Regenerate after adding a
config key, counter group, or span::

    python -m avenir_tpu_torch.analysis --write-registry
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

REGISTRY_PATH = os.path.join(os.path.dirname(__file__), "config_registry.py")
COUNTER_REGISTRY_PATH = os.path.join(os.path.dirname(__file__),
                                     "counter_registry.py")

# a documented key is a backtick span shaped like a dotted properties key:
# lowercase dotted segments (`stream.chunk.rows`), optionally written as
# `-Dkey=value` or `key=value`; single-segment keys (`seed`) only count
# when they appear in a `key` (value) doc position — handled by allowing
# bare [a-z]+ spans too, filtered against the code keys (false positives
# in docs are harmless: only keys the CODE reads enter the registry).
_FENCE_RE = re.compile(r"^```.*?^```\s*$", re.MULTILINE | re.DOTALL)
_BACKTICK_RE = re.compile(r"`([^`\n]+)`")
_KEY_RE = re.compile(r"^[a-z][a-z0-9]*(\.[a-z][a-z0-9]*)*$")


def scan_code_keys(paths: Sequence[str]) -> Dict[str, List[Tuple[str, int]]]:
    """key → [(file, line), ...] for every conf.get*("literal") in the
    non-test .py files under ``paths`` (test files read fixture keys)."""
    from avenir_tpu_torch.analysis.engine import _iter_py_files
    from avenir_tpu_torch.analysis.program import _is_test_file
    from avenir_tpu_torch.analysis.rules import iter_conf_key_calls

    out: Dict[str, List[Tuple[str, int]]] = {}
    for path in _iter_py_files([os.fspath(p) for p in paths]):
        if _is_test_file(path.replace(os.sep, "/")):
            continue
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError:
            continue                      # GL000 reports it; skip here
        for line, key in iter_conf_key_calls(tree):
            out.setdefault(key, []).append((path, line))
    return out


def scan_documented_keys(doc_paths: Sequence[str]) -> Dict[str, str]:
    """key → doc file for every dotted key mentioned in backticks across
    the given markdown files/dirs."""
    files: List[str] = []
    for p in doc_paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if not d.startswith("."))
                files.extend(os.path.join(dirpath, n)
                             for n in sorted(filenames)
                             if n.endswith(".md"))
        elif p.endswith(".md") and os.path.exists(p):
            files.append(p)
    out: Dict[str, str] = {}
    for f in files:
        with open(f, encoding="utf-8") as fh:
            # fenced code blocks would desync the inline-backtick pairing
            # (a ``` fence is an odd run of backticks), so drop them first
            text = _FENCE_RE.sub("", fh.read())
        for span in _BACKTICK_RE.findall(text):
            token = span.strip()
            if token.startswith("-D"):
                token = token[2:]
            token = token.split("=", 1)[0].strip()
            if _KEY_RE.match(token):
                out.setdefault(token, f.replace(os.sep, "/"))
    return out


def write_registry(code_paths: Sequence[str], doc_paths: Sequence[str],
                   root: Optional[str] = None,
                   out_path: str = REGISTRY_PATH) -> Dict[str, Optional[str]]:
    root = os.path.abspath(root or os.getcwd())
    code_keys = scan_code_keys(code_paths)
    documented = scan_documented_keys(doc_paths)

    def rel(p: str) -> str:
        ap = os.path.abspath(p)
        return (os.path.relpath(ap, root) if ap.startswith(root + os.sep)
                else ap).replace(os.sep, "/")

    registry: Dict[str, Optional[str]] = {
        key: (rel(documented[key]) if key in documented else None)
        for key in sorted(code_keys)
    }
    lines = [
        '"""Generated config-key registry — DO NOT EDIT BY HAND.',
        "",
        "Regenerate with `python -m avenir_tpu_torch.analysis --write-registry`",
        "after adding or documenting a config key.  Maps every",
        'conf.get*("…") literal in the code tree to the doc file that',
        "documents it; None = undocumented (GL004 fails the build on it).",
        '"""',
        "",
        "CONFIG_KEYS = {",
    ]
    for key, doc in registry.items():
        lines.append(f"    {key!r}: {doc!r},")
    lines.append("}")
    with open(out_path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return registry


# ---------------------------------------------------------------------------
# counter-group / span-site registry (GL008 ground truth)
# ---------------------------------------------------------------------------

def scan_counter_span_sites(paths: Sequence[str]) \
        -> Tuple[Dict[str, List[Tuple[str, int]]],
                 Dict[str, List[Tuple[str, int]]]]:
    """(group → sites, span-name → sites) for every resolvable
    ``counters.increment/set`` group and tracer ``span``/``emit_span``
    literal under ``paths`` — the same facts extractor GL008 lints with,
    so the registry and the rule can never disagree.  Test files are
    excluded (fixture groups are deliberate)."""
    from avenir_tpu_torch.analysis.engine import _iter_py_files
    from avenir_tpu_torch.analysis.program import _is_test_file, extract_facts

    groups: Dict[str, List[Tuple[str, int]]] = {}
    spans: Dict[str, List[Tuple[str, int]]] = {}
    for path in _iter_py_files([os.fspath(p) for p in paths]):
        if _is_test_file(path.replace(os.sep, "/")):
            continue
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError:
            continue                      # GL000 reports it; skip here
        facts = extract_facts(tree, src, path)
        for site in facts["counter_sites"]:
            groups.setdefault(site["group"], []).append((path,
                                                        site["line"]))
        for site in facts["span_sites"]:
            spans.setdefault(site["name"], []).append((path, site["line"]))
    return groups, spans


def scan_doc_tokens(doc_paths: Sequence[str]) -> Dict[str, str]:
    """token → doc file for every backtick span across the markdown
    tree, with ``<placeholder>`` segments normalized to ``*`` so
    ``Serving.<model>`` in docs matches the ``Serving.*`` pattern the
    code's f-string group normalizes to."""
    files: List[str] = []
    for p in doc_paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if not d.startswith("."))
                files.extend(os.path.join(dirpath, n)
                             for n in sorted(filenames)
                             if n.endswith(".md"))
        elif p.endswith(".md") and os.path.exists(p):
            files.append(p)
    out: Dict[str, str] = {}
    for f in files:
        with open(f, encoding="utf-8") as fh:
            text = _FENCE_RE.sub("", fh.read())
        for span in _BACKTICK_RE.findall(text):
            token = span.strip()
            token = re.sub(r"<[^<>]+>", "*", token)
            token = re.sub(r"\*+", "*", token)
            if token:
                out.setdefault(token, f.replace(os.sep, "/"))
    return out


def write_counter_registry(code_paths: Sequence[str],
                           doc_paths: Sequence[str],
                           root: Optional[str] = None,
                           out_path: str = COUNTER_REGISTRY_PATH) \
        -> Tuple[Dict[str, Optional[str]], Dict[str, Optional[str]]]:
    root = os.path.abspath(root or os.getcwd())
    groups, spans = scan_counter_span_sites(code_paths)
    documented = scan_doc_tokens(doc_paths)

    def rel(p: str) -> str:
        ap = os.path.abspath(p)
        return (os.path.relpath(ap, root) if ap.startswith(root + os.sep)
                else ap).replace(os.sep, "/")

    group_reg: Dict[str, Optional[str]] = {
        g: (rel(documented[g]) if g in documented else None)
        for g in sorted(groups)
    }
    span_reg: Dict[str, Optional[str]] = {
        s: (rel(documented[s]) if s in documented else None)
        for s in sorted(spans)
    }
    lines = [
        '"""Generated counter-group / span-site registry — DO NOT EDIT',
        "BY HAND.",
        "",
        "Regenerate with `python -m avenir_tpu_torch.analysis --write-registry`",
        "after adding a counter group or span name.  Maps every",
        "resolvable Counters group and tracer span literal in the code",
        "tree to the doc file that documents it; None = undocumented",
        "(GL008 fails the build on it).  F-string names are normalized",
        'to wildcards ("Serving.*"), matching docs written as',
        '"Serving.<model>".',
        '"""',
        "",
        "COUNTER_GROUPS = {",
    ]
    for key, doc in group_reg.items():
        lines.append(f"    {key!r}: {doc!r},")
    lines.append("}")
    lines.append("")
    lines.append("SPAN_SITES = {")
    for key, doc in span_reg.items():
        lines.append(f"    {key!r}: {doc!r},")
    lines.append("}")
    with open(out_path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return group_reg, span_reg

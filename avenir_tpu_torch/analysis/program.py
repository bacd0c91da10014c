"""graftlint whole-program pass — per-file facts, project context, and the
cross-file rules GL006–GL008.

The engine runs two phases (engine.py):

1. **per-file** — parse once, run the local rules (rules.py), and extract
   a JSON-serializable *facts* record: symbol table, import targets, call
   edges, lock regions with the calls they enclose, journal-emit sites,
   counter/span sites.  Facts are content-hash-cached, so a warm re-run
   never re-parses unchanged files.
2. **project** — build a :class:`ProjectContext` over every file's facts
   (symbol index, import graph, transitive I/O closure) and run the
   project rules below.  This phase is always fresh and cheap (pure dict
   work over the aggregated facts).

Everything is stdlib-only; the golden event schema
(``avenir_tpu_torch/telemetry/schema.py``) is loaded standalone
(``importlib``) so linting never imports the telemetry package (or torch).
"""

from __future__ import annotations

import ast
import importlib.util
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from avenir_tpu_torch.analysis.rules import _dotted, _unparse

_ANALYSIS_DIR = os.path.dirname(__file__)
EVENT_SCHEMA_PATH = os.path.normpath(
    os.path.join(_ANALYSIS_DIR, os.pardir, "telemetry", "schema.py"))

# dotted-name tails whose call is journal/file I/O when the receiver looks
# like the tracer/journal/span plumbing (``tel.tracer().event(...)``,
# ``self.journal.emit(...)``, ``_TRACER.gauge(...)``)
_EMIT_TAILS = {"event", "event_once", "gauge", "counters", "emit",
               "emit_span", "_journal_emit"}
_EMIT_RECEIVER_HINTS = ("tracer", "journal", "tel.", "span")

# threading lock constructors — a ``with`` over a name assigned from one
# of these opens a lock region (FileLock deliberately NOT here: file I/O
# under a FileLock is the locking discipline, not the hazard)
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}

_EVENT_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+)+$")


# ---------------------------------------------------------------------------
# per-file facts extraction
# ---------------------------------------------------------------------------

def _is_test_file(relpath: str) -> bool:
    base = os.path.basename(relpath)
    return ("tests/" in relpath.replace(os.sep, "/")
            or base.startswith("test_") or base == "conftest.py")


def _sink(call: ast.Call) -> Optional[str]:
    """Non-None when this call IS file/journal I/O: ``open()``, a FileLock
    acquire, or a tracer/journal emit."""
    func = call.func
    dotted = _dotted(func) or ""
    tail = dotted.split(".")[-1] if dotted else (
        func.attr if isinstance(func, ast.Attribute) else "")
    if dotted == "open":
        return "open()"
    if tail == "FileLock":
        return "FileLock()"
    if tail in _EMIT_TAILS:
        recv = _unparse(func.value).lower() \
            if isinstance(func, ast.Attribute) else ""
        if tail == "_journal_emit" and recv in ("self", "cls"):
            return f"journal {tail}()"
        if any(h in recv for h in _EMIT_RECEIVER_HINTS):
            return f"journal {tail}()"
    return None


def _emit_site(call: ast.Call) -> Optional[Tuple[str, str]]:
    """(kind, event-name) for a tracer/span ``.event("literal")`` /
    ``.event_once("literal")`` call; None for dynamic names or non-emit
    calls.  Raw ``Journal.emit`` is excluded: the Journal is
    schema-agnostic plumbing (tests journal fixture events through it)."""
    func = call.func
    if not isinstance(func, ast.Attribute) or \
            func.attr not in ("event", "event_once", "_journal_emit"):
        return None
    recv = _unparse(func.value).lower()
    # "self"/"cls" receivers cover the Tracer's own internal emits
    # (self.event("counters", ...), self._journal_emit("span.open", ...))
    if recv not in ("self", "cls") and \
            not any(h in recv for h in _EMIT_RECEIVER_HINTS):
        return None
    if call.args and isinstance(call.args[0], ast.Constant) and \
            isinstance(call.args[0].value, str):
        return func.attr, call.args[0].value
    return None


def _call_ref(call: ast.Call) -> Optional[dict]:
    """A resolvable reference to the callee, or None (calls on call
    results, subscripts, deep attribute chains)."""
    dotted = _dotted(call.func)
    if not dotted:
        return None
    parts = dotted.split(".")
    if len(parts) == 1:
        return {"k": "name", "n": parts[0]}
    if parts[0] in ("self", "cls") and len(parts) == 2:
        return {"k": "self", "n": parts[1]}
    if len(parts) == 2:
        return {"k": "dotted", "t": dotted}
    return None


def _fstring_pattern(node: ast.AST) -> Optional[str]:
    """'Serving.*' for ``f"Serving.{model}"``; the literal itself for a
    plain string; None otherwise."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            elif isinstance(v, ast.FormattedValue):
                parts.append("*")
            else:
                return None
        pat = "".join(parts)
        return re.sub(r"\*+", "*", pat)
    return None


class _FactsVisitor(ast.NodeVisitor):
    """One walk producing the whole facts record for a file."""

    def __init__(self, src: str, relpath: str):
        self.relpath = relpath
        self.facts: dict = {
            "defs": {}, "classes": {}, "imports": {},
            "calls": [], "io_direct": [], "lock_regions": [],
            "emits": [], "deferred_events": [],
            "counter_sites": [], "span_sites": [], "thread_targets": [],
        }
        # stacks
        self._cls: List[str] = []
        self._fn: List[str] = []
        self._locks: List[dict] = []
        # name → last literal/f-string assignment per function (def-use
        # for counter groups passed through a variable)
        self._str_assigns: List[Dict[str, str]] = [{}]
        # module-level constants: NAME = ("Group", "name") tuples
        self._module_tuples: Dict[str, str] = {}
        # names assigned from threading lock constructors
        self._lock_names: Set[str] = set()

    # -- scopes -------------------------------------------------------------
    def _qual(self) -> Optional[str]:
        if not self._fn:
            return None
        return ".".join(self._fn)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.facts["classes"][node.name] = {
            "line": node.lineno,
            "methods": [n.name for n in node.body
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))],
        }
        self._cls.append(node.name)
        self._fn.append(node.name)
        self.generic_visit(node)
        self._fn.pop()
        self._cls.pop()

    def _visit_fn(self, node) -> None:
        self._fn.append(node.name)
        self.facts["defs"][".".join(self._fn)] = node.lineno
        self._str_assigns.append({})
        self.generic_visit(node)
        self._str_assigns.pop()
        self._fn.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    # -- imports ------------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            local = alias.asname or alias.name.split(".")[0]
            self.facts["imports"][local] = {"mod": alias.name, "attr": None}

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        if node.level:
            pkg = os.path.dirname(self.relpath).replace(os.sep, "/")
            parts = pkg.split("/")
            if node.level > 1:
                parts = parts[:len(parts) - (node.level - 1)]
            mod = ".".join(parts + ([mod] if mod else []))
        for alias in node.names:
            local = alias.asname or alias.name
            self.facts["imports"][local] = {"mod": mod, "attr": alias.name}

    # -- assignments (def-use for groups, lock names, module tuples) --------
    def visit_Assign(self, node: ast.Assign) -> None:
        value_txt = _unparse(node.value)
        pat = _fstring_pattern(node.value)
        for tgt in node.targets:
            name = _dotted(tgt)
            if name is None:
                continue
            tail = name.split(".")[-1]
            if isinstance(node.value, ast.Call):
                ctor = (_dotted(node.value.func) or "").split(".")[-1]
                if ctor in _LOCK_CTORS and "FileLock" not in value_txt:
                    self._lock_names.add(tail)
            if pat is not None:
                self._str_assigns[-1][tail] = pat
            if not self._fn and isinstance(node.value, ast.Tuple) and \
                    node.value.elts and \
                    isinstance(node.value.elts[0], ast.Constant) and \
                    isinstance(node.value.elts[0].value, str):
                self._module_tuples[tail] = node.value.elts[0].value
        self.generic_visit(node)

    # -- lock regions -------------------------------------------------------
    def _is_lock_expr(self, expr: ast.AST) -> bool:
        name = _dotted(expr)
        if name is None:
            return False
        return name.split(".")[-1] in self._lock_names

    def visit_With(self, node: ast.With) -> None:
        lock_items = [it for it in node.items
                      if self._is_lock_expr(it.context_expr)]
        if lock_items:
            region = {"fn": self._qual(), "lock_line": node.lineno,
                      "lock": _unparse(lock_items[0].context_expr),
                      "calls": []}
            self.facts["lock_regions"].append(region)
            self._locks.append(region)
            self.generic_visit(node)
            self._locks.pop()
        else:
            self.generic_visit(node)

    # -- calls --------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        qual = self._qual()
        sink = _sink(node)
        ref = _call_ref(node)
        if sink is not None:
            self.facts["io_direct"].append(
                {"fn": qual, "line": node.lineno, "what": sink})
        elif ref is not None:
            self.facts["calls"].append(
                {"fn": qual, "line": node.lineno, "ref": ref})
        if self._locks and self._locks[-1]["fn"] == qual:
            self._locks[-1]["calls"].append(
                {"line": node.lineno, "sink": sink, "ref": ref,
                 "text": _unparse(node.func)})
        emit = _emit_site(node)
        if emit is not None:
            self.facts["emits"].append(
                {"line": node.lineno, "kind": emit[0], "name": emit[1]})
        self._counter_or_span_site(node)
        self._thread_target(node)
        self.generic_visit(node)

    # -- counter / span sites ----------------------------------------------
    def _counter_or_span_site(self, node: ast.Call) -> None:
        func = node.func
        if not isinstance(func, ast.Attribute):
            return
        recv = _unparse(func.value).lower()
        if func.attr in ("increment", "set") and "counter" in recv:
            group = None
            if node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Starred):
                    const = self._module_tuples.get(
                        (_dotted(arg.value) or "").split(".")[-1])
                    group = const
                else:
                    group = _fstring_pattern(arg)
                    if group is None and isinstance(arg, ast.Name):
                        for scope in reversed(self._str_assigns):
                            if arg.id in scope:
                                group = scope[arg.id]
                                break
            if group is not None:
                self.facts["counter_sites"].append(
                    {"line": node.lineno, "group": group})
        elif func.attr in ("span", "emit_span") and \
                any(h in recv for h in _EMIT_RECEIVER_HINTS):
            if node.args:
                name = _fstring_pattern(node.args[0])
                if name is not None:
                    self.facts["span_sites"].append(
                        {"line": node.lineno, "name": name})

    # -- thread targets (facts for GL009, resolved locally) -----------------
    def _thread_target(self, node: ast.Call) -> None:
        dotted = _dotted(node.func) or ""
        if dotted.split(".")[-1] != "Thread":
            return
        for kw in node.keywords:
            if kw.arg == "target":
                ref = _call_ref(ast.Call(func=kw.value, args=[],
                                         keywords=[]))
                self.facts["thread_targets"].append(
                    {"line": node.lineno, "ref": ref,
                     "text": _unparse(kw.value)})


def extract_facts(tree: ast.AST, src: str, relpath: str) -> dict:
    visitor = _FactsVisitor(src, relpath)
    # prescan: lock-name assignments can appear after their use sites
    # (methods defined above __init__) — collect them first
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            ctor = (_dotted(node.value.func) or "").split(".")[-1]
            if ctor in _LOCK_CTORS:
                for tgt in node.targets:
                    name = _dotted(tgt)
                    if name:
                        visitor._lock_names.add(name.split(".")[-1])
    # deferred-fire tuples: ("tenant.throttled", {...}) appended under a
    # lock and emitted after release (tenancy/arbiter.py) — these count as
    # live emit sites for GL007's liveness direction (never for the
    # unknown-name direction: arbitrary dotted tuples would false-flag)
    deferred = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Tuple) and node.elts and \
                isinstance(node.elts[0], ast.Constant) and \
                isinstance(node.elts[0].value, str) and \
                _EVENT_NAME_RE.match(node.elts[0].value):
            deferred.add(node.elts[0].value)
    visitor.visit(tree)
    visitor.facts["deferred_events"] = sorted(deferred)
    return visitor.facts


# ---------------------------------------------------------------------------
# registries the project rules check against
# ---------------------------------------------------------------------------

@dataclass
class EventSchema:
    """The golden journal-event schema, loaded standalone from
    ``telemetry/schema.py`` (no package import — never pulls in torch)."""

    names: Dict[str, int]                  # event → line in the schema file
    once: Set[str]
    relpath: str
    explicit: bool = False                 # passed by the caller (tests)


def load_event_schema(path: Optional[str] = None,
                      explicit: bool = False) -> Optional[EventSchema]:
    path = path or EVENT_SCHEMA_PATH
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location("_graftlint_schema", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src_lines = open(path, encoding="utf-8").read().splitlines()
    names: Dict[str, int] = {}
    for ev in mod.GOLDEN_EVENT_KEYS:
        line = next((i for i, ln in enumerate(src_lines, 1)
                     if f'"{ev}"' in ln), 1)
        names[ev] = line
    return EventSchema(names=names, once=set(getattr(mod, "EVENT_ONCE", ())),
                       relpath=path, explicit=explicit)


def load_counter_registry() -> Optional[dict]:
    try:
        from avenir_tpu_torch.analysis.counter_registry import (COUNTER_GROUPS,
                                                          SPAN_SITES)
        return {"groups": COUNTER_GROUPS, "spans": SPAN_SITES}
    except ImportError:                        # registry not generated yet
        return None


# ---------------------------------------------------------------------------
# project context
# ---------------------------------------------------------------------------

@dataclass
class ProjectContext:
    """Aggregated facts for every linted file: symbol index, import graph,
    and the transitive file/journal-I/O closure GL006 walks."""

    files: Dict[str, dict]                 # relpath → facts
    root: str = ""
    event_schema: Optional[EventSchema] = None
    counter_registry: Optional[dict] = None
    modmap: Dict[str, str] = field(default_factory=dict)
    io_reach: Set[Tuple[str, str]] = field(default_factory=set)

    def __post_init__(self) -> None:
        for rel in self.files:
            mod = rel[:-3] if rel.endswith(".py") else rel
            if mod.endswith("/__init__"):
                mod = mod[:-len("/__init__")]
            self.modmap[mod.replace("/", ".")] = rel
        self._build_io_closure()

    # -- symbol resolution --------------------------------------------------
    def _target_in_module(self, rel: str, name: str) \
            -> Optional[Tuple[str, str]]:
        facts = self.files.get(rel)
        if facts is None:
            return None
        if name in facts["classes"]:
            if "__init__" in facts["classes"][name]["methods"]:
                return (rel, f"{name}.__init__")
            return (rel, name)
        if name in facts["defs"]:
            return (rel, name)
        return None

    def resolve(self, rel: str, fn_qual: Optional[str],
                ref: Optional[dict]) -> Optional[Tuple[str, str]]:
        """(file, qual) the reference points at, or None (unresolvable —
        attribute chains on arbitrary objects never produce findings)."""
        if ref is None:
            return None
        facts = self.files[rel]
        if ref["k"] == "self":
            cls = (fn_qual or "").split(".")[0]
            if cls in facts["classes"] and \
                    ref["n"] in facts["classes"][cls]["methods"]:
                return (rel, f"{cls}.{ref['n']}")
            return None
        if ref["k"] == "name":
            local = self._target_in_module(rel, ref["n"])
            if local is not None:
                return local
            imp = facts["imports"].get(ref["n"])
            if imp is not None and imp["attr"] is not None:
                target_rel = self.modmap.get(imp["mod"])
                if target_rel is not None:
                    return self._target_in_module(target_rel, imp["attr"])
            return None
        if ref["k"] == "dotted":
            first, attr = ref["t"].split(".", 1)
            imp = facts["imports"].get(first)
            if imp is not None and imp["attr"] is None:
                target_rel = self.modmap.get(imp["mod"])
                if target_rel is not None:
                    return self._target_in_module(target_rel, attr)
            return None
        return None

    # -- transitive I/O closure ---------------------------------------------
    def _build_io_closure(self) -> None:
        reach: Set[Tuple[str, str]] = set()
        for rel, facts in self.files.items():
            for rec in facts["io_direct"]:
                if rec["fn"] is not None:
                    reach.add((rel, rec["fn"]))
        edges: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
        for rel, facts in self.files.items():
            for rec in facts["calls"]:
                if rec["fn"] is None:
                    continue
                tgt = self.resolve(rel, rec["fn"], rec["ref"])
                if tgt is not None:
                    edges.setdefault(tgt, set()).add((rel, rec["fn"]))
        frontier = list(reach)
        while frontier:
            tgt = frontier.pop()
            for caller in edges.get(tgt, ()):
                if caller not in reach:
                    reach.add(caller)
                    frontier.append(caller)
        self.io_reach = reach


# ---------------------------------------------------------------------------
# project rules — (relpath, line, message) triples
# ---------------------------------------------------------------------------

ProjectResult = List[Tuple[str, int, str]]


def check_gl006(ctx: ProjectContext) -> ProjectResult:
    """File/journal I/O (journal emit, FileLock acquire, ``open``)
    reachable inside a held ``threading.Lock``/``RLock``/``Condition``
    region.  The review class fixed twice in the tenancy plane: a journal
    write under the arbiter/door lock serializes every other tenant's grant behind
    one shed storm's file I/O.  Defer the emit past the release
    (tenancy/arbiter.py's ``fires`` list) instead."""
    out: ProjectResult = []
    for rel, facts in ctx.files.items():
        for region in facts["lock_regions"]:
            for call in region["calls"]:
                if call["sink"] is not None:
                    out.append((rel, call["line"], (
                        f"{call['sink']} inside a held lock region "
                        f"({region['lock']} at line "
                        f"{region['lock_line']}) — journal/file I/O under "
                        f"a threading lock serializes every other holder "
                        f"behind the write; defer the emit past the "
                        f"release (tenancy/arbiter.py fires-list pattern)")))
                    continue
                tgt = ctx.resolve(rel, region["fn"], call["ref"])
                if tgt is not None and tgt in ctx.io_reach:
                    out.append((rel, call["line"], (
                        f"call {call['text']}() reaches file/journal I/O "
                        f"({tgt[0]}::{tgt[1]}) inside a held lock region "
                        f"({region['lock']} at line "
                        f"{region['lock_line']}) — defer the I/O past the "
                        f"release (tenancy/arbiter.py fires-list pattern)")))
    return out


def check_gl007(ctx: ProjectContext) -> ProjectResult:
    """Journal-event-name drift, both directions (the GL004 registry
    pattern pointed at events): every tracer ``.event("x.y")`` literal
    must exist in ``telemetry/schema.py``'s golden schema, and every
    schema event must still have a live emit site (literal call or a
    deferred-fire tuple).  The drift class the golden-schema gate kept
    catching one review late."""
    schema = ctx.event_schema
    if schema is None:
        return []
    out: ProjectResult = []
    emitted: Set[str] = set()
    for rel, facts in ctx.files.items():
        emitted.update(facts["deferred_events"])
        for emit in facts["emits"]:
            emitted.add(emit["name"])
            if emit["name"] not in schema.names:
                out.append((rel, emit["line"], (
                    f"journal event {emit['name']!r} is not in the golden "
                    f"event schema (telemetry/schema.py GOLDEN_EVENT_KEYS) "
                    f"— add it with its exact key set (and document it in "
                    f"docs/observability.md), or fix the name")))
    # the liveness direction only makes sense over the full tree (or when
    # a test hands us a schema explicitly): linting a subdirectory must
    # not declare every un-emitted event dead
    schema_rel = os.path.relpath(schema.relpath, ctx.root or os.getcwd())
    schema_rel = schema_rel.replace(os.sep, "/")
    if schema.explicit or schema_rel in ctx.files:
        for ev, line in schema.names.items():
            if ev not in emitted:
                out.append((schema_rel, line, (
                    f"schema event {ev!r} has no live emit site in the "
                    f"linted tree — remove it from GOLDEN_EVENT_KEYS or "
                    f"restore its producer")))
    return out


def check_gl008(ctx: ProjectContext) -> ProjectResult:
    """Counter-group / span-name drift against the generated registry
    (``analysis/counter_registry.py`` — same discipline as GL004's config
    registry).  F-string groups like ``f"Serving.{model}"`` normalize to
    ``Serving.*`` and match docs written as ``Serving.<model>``.  Test
    files are exempt (fixture groups are deliberate)."""
    registry = ctx.counter_registry
    if registry is None:
        return []
    out: ProjectResult = []
    for rel, facts in ctx.files.items():
        if _is_test_file(rel):
            continue
        for site in facts["counter_sites"]:
            doc = registry["groups"].get(site["group"], KeyError)
            if doc is KeyError:
                out.append((rel, site["line"], (
                    f"counter group {site['group']!r} is not in "
                    f"analysis/counter_registry.py — regenerate with "
                    f"`python -m avenir_tpu_torch.analysis --write-registry`")))
            elif doc is None:
                out.append((rel, site["line"], (
                    f"counter group {site['group']!r} is undocumented — "
                    f"no docs/*.md mentions it; add it to "
                    f"docs/observability.md and regenerate the registry")))
        for site in facts["span_sites"]:
            doc = registry["spans"].get(site["name"], KeyError)
            if doc is KeyError:
                out.append((rel, site["line"], (
                    f"span name {site['name']!r} is not in "
                    f"analysis/counter_registry.py — regenerate with "
                    f"`python -m avenir_tpu_torch.analysis --write-registry`")))
            elif doc is None:
                out.append((rel, site["line"], (
                    f"span name {site['name']!r} is undocumented — no "
                    f"docs/*.md span table mentions it; add it to "
                    f"docs/observability.md and regenerate the registry")))
    return out


PROJECT_RULES = {
    "GL006": check_gl006,
    "GL007": check_gl007,
    "GL008": check_gl008,
}

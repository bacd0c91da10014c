"""graftlint rules for the PyTorch port — the local rules GL001–GL005 and
GL009–GL012, each encoding a bug class found by hand in this codebase (see
docs/analysis.md for the history).

The AST logic is the JAX package's (``avenir_tpu/analysis/rules.py``);
only the idiom tables differ: GL001's collectives are the port's
``all_process_sum_state`` / ``all_process_gather_state`` and the
``torch.distributed`` calls a process can enter with divergent state, and
GL005's host syncs are ``.item()`` / ``.cpu()`` / ``.tolist()`` /
``.numpy()`` / ``torch.cuda.synchronize()`` and ``float``/``np.asarray``
of a tensor.

All rules are pure-AST (stdlib ``ast`` only) and deliberately scoped to the
patterns this codebase actually uses, trading generality for a near-zero
false-positive rate: a lint gate that cries wolf gets suppressed wholesale
and protects nothing.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

RuleResult = List[Tuple[int, str]]          # (line, message)


@dataclass
class RuleContext:
    src: str
    relpath: str
    # GL004: key → doc location (None = undocumented); None = load default
    config_keys: Optional[dict] = None
    # GL011: events documented once-per-run (telemetry/schema.py
    # EVENT_ONCE); None = load default from the schema file
    event_once: Optional[frozenset] = None


# ---------------------------------------------------------------------------
# shared AST plumbing
# ---------------------------------------------------------------------------

def _attach_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._gl_parent = node          # type: ignore[attr-defined]


def _ancestors(node: ast.AST) -> Iterator[ast.AST]:
    cur = getattr(node, "_gl_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "_gl_parent", None)


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for Attribute/Name chains; None for anything else
    (calls on call results, subscripts, ...)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _functions(tree: ast.AST) -> Iterator[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    for anc in _ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def _in_loop(node: ast.AST, stop_at: Optional[ast.AST] = None) -> bool:
    for anc in _ancestors(node):
        if anc is stop_at:
            return False
        if isinstance(anc, (ast.For, ast.AsyncFor, ast.While)):
            return True
    return False


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:                         # pragma: no cover
        return ""


# ---------------------------------------------------------------------------
# GL001 — collective divergence
# ---------------------------------------------------------------------------

# the multi-process merge seams (parallel/mesh.py over torch.distributed):
# a value that differs across processes must never be computed on the path
# into one of these without either a writer guard (process 0 computes, the
# collective itself broadcasts) or the error-through-the-collective pattern
_GL001_SINKS = ("all_process_sum_state", "all_process_gather_state",
                "all_gather", "all_gather_object", "broadcast",
                "broadcast_object_list", "all_reduce", "barrier")

# process-divergent value producers: unlocked file reads, env, clocks, RNG,
# and per-process checkpoint restores
_GL001_SOURCE_CALLS = {"open", "load_state", "torch.load"}
_GL001_SOURCE_DOTTED_PREFIXES = (
    "os.environ", "os.getenv", "time.time", "time.monotonic",
    "time.perf_counter", "random.", "np.random.", "numpy.random.",
    "torch.rand",
)
_GL001_SOURCE_METHOD_SUFFIXES = (".restore",)

# writer / rank checks: Job.is_output_writer, parallel/mesh.py::process_grid
# (rank, world size), torch.distributed.get_rank / get_world_size.  An
# identifier in the test must equal one of these exactly: ``ranked`` or
# ``rank_exact`` guard nothing
_GL001_GUARDS = frozenset({"is_output_writer", "process_grid", "rank",
                           "get_rank", "nprocs", "world_size",
                           "get_world_size"})


def _gl001_guard_test(test: ast.AST) -> bool:
    for n in ast.walk(test):
        if isinstance(n, ast.Name) and n.id in _GL001_GUARDS:
            return True
        if isinstance(n, ast.Attribute) and n.attr in _GL001_GUARDS:
            return True
    return False


def _gl001_is_source(call: ast.Call) -> Optional[str]:
    dotted = _dotted(call.func)
    if dotted is None:
        return None
    if dotted in _GL001_SOURCE_CALLS:
        return dotted
    for prefix in _GL001_SOURCE_DOTTED_PREFIXES:
        if dotted == prefix.rstrip(".") or dotted.startswith(prefix):
            return dotted
    for suffix in _GL001_SOURCE_METHOD_SUFFIXES:
        if dotted.endswith(suffix):
            return dotted
    return None


def _gl001_guarded(node: ast.AST, fn: ast.AST) -> bool:
    for anc in _ancestors(node):
        if anc is fn:
            return False
        if isinstance(anc, ast.If) and _gl001_guard_test(anc.test):
            return True
    return False


def check_gl001(tree: ast.AST, ctx: RuleContext) -> RuleResult:
    """Process-divergent value (unlocked read / env / clock / RNG /
    per-process restore) computed in a function that enters a cross-process
    collective, without a writer guard.  The jobs/regress.py bug class:
    peers read the LR coefficient file independently of the writer's locked
    read, then entered the gradient collective with different resume
    weights."""
    _attach_parents(tree)
    out: RuleResult = []
    for fn in _functions(tree):
        has_sink = any(
            isinstance(n, ast.Call)
            and (_dotted(n.func) or "").split(".")[-1] in _GL001_SINKS
            for n in ast.walk(fn))
        if not has_sink:
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if _enclosing_function(node) is not fn:
                continue                     # belongs to a nested function
            src_name = _gl001_is_source(node)
            if src_name is None or _gl001_guarded(node, fn):
                continue
            out.append((node.lineno, (
                f"process-divergent value from {src_name}() computed in a "
                f"function that enters a cross-process collective "
                f"({'/'.join(_GL001_SINKS[:3])}, ...) without a writer "
                f"guard — route it through process 0 + the collective "
                f"itself (copy avenir_tpu_torch/jobs/regress.py::"
                f"_broadcast_resume)")))
    return out


# ---------------------------------------------------------------------------
# GL002 — unfingerprinted checkpoint/accumulator keys
# ---------------------------------------------------------------------------

_GL002_IDENTITY_HINTS = ("run", "fingerprint", "fp", "key", "id", "meta",
                         "schema")


def check_gl002(tree: ast.AST, ctx: RuleContext) -> RuleResult:
    """Checkpoint/accumulator state that doesn't fingerprint the
    configuration that produced it.  The models/correlation.py bug class:
    einsum-path keys named only c0, c256, ... restored cleanly after the
    attribute lists changed, silently summing incompatible pair counts
    (fixed by the ``_einsum_key_prefix`` fingerprint).

    Pattern A: a dict literal passed to a checkpoint ``save`` whose keys
    carry no identity/fingerprint component (``run``/``id``/...).
    Pattern B: an f-string accumulator key whose literal part is a bare
    1–3 letter tag and whose placeholders are plain loop indices — no
    fingerprint variable qualifies the key family.
    """
    _attach_parents(tree)
    out: RuleResult = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func) or ""
        tail = dotted.split(".")[-1]
        receiver = dotted.rsplit(".", 1)[0] if "." in dotted else ""
        # -- pattern A: snapshot dict without an identity key -------------
        if tail in ("save", "save_state") and (
                "save_state" in dotted or "mgr" in receiver
                or "manager" in receiver or "checkpoint" in receiver):
            for arg in node.args:
                if not isinstance(arg, ast.Dict):
                    continue
                keys = [k.value for k in arg.keys
                        if isinstance(k, ast.Constant)
                        and isinstance(k.value, str)]
                if keys and not any(
                        h in k for k in keys for h in _GL002_IDENTITY_HINTS):
                    out.append((arg.lineno, (
                        f"checkpoint snapshot dict {{{', '.join(keys)}}} "
                        f"carries no run/config identity key — a stale "
                        f"snapshot from another configuration restores "
                        f"silently (the models/correlation.py einsum-key "
                        f"class); "
                        f"add a fingerprint entry and validate on restore")))
        # -- pattern B: bare-index accumulator key family -----------------
        if tail == "add" and "acc" in dotted.split(".")[0].lower() and \
                node.args and isinstance(node.args[0], ast.JoinedStr):
            key = node.args[0]
            first = key.values[0] if key.values else None
            if (isinstance(first, ast.Constant)
                    and isinstance(first.value, str)
                    and re.fullmatch(r"[a-z]{1,3}", first.value)
                    and all(isinstance(v, (ast.Constant, ast.FormattedValue))
                            for v in key.values)):
                out.append((key.lineno, (
                    f"accumulator key {_unparse(key)!r} is a bare "
                    f"tag+index with no configuration fingerprint "
                    f"component — a checkpoint restored under a different "
                    f"configuration produces the same key names and sums "
                    f"incompatible partials; qualify the key family like "
                    f"models/correlation.py::_einsum_key_prefix")))
    return out


# ---------------------------------------------------------------------------
# GL003 — fixed-width format keys without a bound assert
# ---------------------------------------------------------------------------

_WIDTH_RE = re.compile(r"^0(\d+)d$")


def _gl003_has_bound_check(scope: ast.AST, width: int) -> bool:
    """True when the enclosing scope compares something against 10**width
    (either spelling) — the loud-failure guard that keeps lexicographic
    order == numeric order inside the key width."""
    bound = 10 ** width
    for node in ast.walk(scope):
        if isinstance(node, ast.Constant) and node.value == bound:
            return True
        if (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Pow)
                and isinstance(node.left, ast.Constant)
                and node.left.value == 10
                and isinstance(node.right, ast.Constant)
                and node.right.value == width):
            return True
    return False


def check_gl003(tree: ast.AST, ctx: RuleContext) -> RuleResult:
    """``{x:0Nd}`` fixed-width keys with no adjacent 10**N bound check.
    The jobs/chombo.py bug class: ``c{idx:08d}`` snapshot keys silently
    mis-ordered the ascending-key finalize fold past 10^8 chunks (the
    fixed path now asserts ``idx < 10**12``).
    Sorted folds, directory names, and generated ids all merge or list
    lexicographically, so a value past the width reorders silently."""
    _attach_parents(tree)
    out: RuleResult = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.FormattedValue) or \
                node.format_spec is None:
            continue
        spec = "".join(
            v.value for v in node.format_spec.values
            if isinstance(v, ast.Constant) and isinstance(v.value, str))
        m = _WIDTH_RE.match(spec)
        if not m:
            continue
        width = int(m.group(1))
        scope = _enclosing_function(node) or tree
        if _gl003_has_bound_check(scope, width):
            continue
        out.append((node.lineno, (
            f"fixed-width key format ':{spec}' has no adjacent 10**{width} "
            f"bound check — values past the width silently break "
            f"lexicographic==numeric ordering (the jobs/chombo.py "
            f"snapshot-key class); assert/raise against 10**{width} in the same "
            f"function, or widen the field")))
    return out


# ---------------------------------------------------------------------------
# GL004 — config keys outside the generated registry / undocumented
# ---------------------------------------------------------------------------

_CONF_GETTERS = {"get", "get_int", "get_float", "get_bool", "get_list",
                 "get_int_list", "get_float_list"}


def iter_conf_key_calls(tree: ast.AST) -> Iterator[Tuple[int, str]]:
    """(line, key) for every ``conf.get*("literal")`` call — shared by the
    GL004 check and the registry generator so they can never disagree on
    what counts as a config-key read."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _CONF_GETTERS):
            continue
        dotted = _dotted(node.func) or ""
        receiver = dotted.rsplit(".", 1)[0].split(".")[-1].lower()
        if "conf" not in receiver and "cfg" not in receiver:
            continue                    # dict.get(...) etc, not a JobConfig
        if node.args and isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            yield node.args[0].lineno, node.args[0].value


def _default_config_keys() -> dict:
    try:
        from avenir_tpu_torch.analysis.config_registry import CONFIG_KEYS
        return CONFIG_KEYS
    except ImportError:                      # registry not generated yet
        return {}


def check_gl004(tree: ast.AST, ctx: RuleContext) -> RuleResult:
    """Every ``conf.get*("…")`` literal must exist in the generated
    ``analysis/config_registry.py`` AND be documented in docs/.  The drift
    this catches: keys like ``class.condtion.weighted`` (the reference's
    own typo, kept for compat) living in code with no doc trail, so config
    written against docs/jobs.md silently does nothing."""
    registry = ctx.config_keys if ctx.config_keys is not None \
        else _default_config_keys()
    out: RuleResult = []
    for line, key in iter_conf_key_calls(tree):
        if key not in registry:
            out.append((line, (
                f"unknown config key {key!r} — not in "
                f"analysis/config_registry.py; regenerate with "
                f"`python -m avenir_tpu_torch.analysis --write-registry` and "
                f"document the key in docs/jobs.md")))
        elif registry[key] is None:
            out.append((line, (
                f"config key {key!r} is undocumented — no docs/*.md "
                f"mentions it; add it to docs/jobs.md and regenerate the "
                f"registry")))
    return out


# ---------------------------------------------------------------------------
# GL005 — host sync inside a hot loop
# ---------------------------------------------------------------------------

_GL005_SYNC_DOTTED = {"torch.cuda.synchronize"}
_GL005_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
_GL005_FETCHERS = {"float", "int", "np.asarray", "np.array",
                   "numpy.asarray", "numpy.array"}
_GL005_DEVICE_PREFIXES = ("torch.",)
_GL005_DEVICE_METHODS = {"to", "cuda"}
# torch calls that return Python scalars or host objects, never a tensor:
# the torch.cuda queries (memory_allocated, device_count, ...), the
# process-group queries and the build/version facts
_GL005_HOST_PREFIXES = ("torch.cuda.", "torch.distributed.get_",
                        "torch.distributed.is_", "torch.backends.",
                        "torch.version.")


def _gl005_device_call(call: ast.AST) -> bool:
    """A call whose result is a tensor that may live on the card: any
    ``torch.`` call but the host queries, or a ``.to(...)`` / ``.cuda()``
    move."""
    if not isinstance(call, ast.Call):
        return False
    if isinstance(call.func, ast.Attribute) and \
            call.func.attr in _GL005_DEVICE_METHODS:
        return True
    dotted = _dotted(call.func) or ""
    if any(dotted.startswith(p) for p in _GL005_HOST_PREFIXES):
        return False
    return any(dotted.startswith(p) for p in _GL005_DEVICE_PREFIXES)


def check_gl005(tree: ast.AST, ctx: RuleContext) -> RuleResult:
    """``.item()`` / ``.cpu()`` / ``.tolist()`` / ``.numpy()`` /
    ``torch.cuda.synchronize()`` / ``float(tensor)`` /
    ``np.asarray(tensor)`` inside a ``for``/``while`` loop: on a CUDA
    tensor each iteration drains the stream and pays a host↔device round
    trip, serializing the pipeline — the tree-induction wall that
    ``models/tree.py::_device_select_splits`` exists to avoid.  Values
    are "tensors" when assigned in the same function from a ``torch.``
    call or a ``.to(...)`` / ``.cuda()`` move.  A designed per-iteration
    fetch says why on a ``# graftlint: disable=GL005`` comment."""
    _attach_parents(tree)
    out: RuleResult = []
    for fn in _functions(tree):
        tainted = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and \
                    _gl005_device_call(node.value):
                for tgt in node.targets:
                    for t in ast.walk(tgt):
                        if isinstance(t, ast.Name):
                            tainted.add(t.id)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if _enclosing_function(node) is not fn:
                continue
            if not _in_loop(node, stop_at=fn):
                continue
            dotted = _dotted(node.func) or ""
            hit = None
            if dotted in _GL005_SYNC_DOTTED:
                hit = f"{dotted}()"
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _GL005_SYNC_METHODS and not node.args:
                hit = f".{node.func.attr}()"
            elif dotted in _GL005_FETCHERS and node.args:
                arg = node.args[0]
                base = arg
                while isinstance(base, (ast.Subscript, ast.Attribute)):
                    base = base.value
                if (isinstance(base, ast.Name) and base.id in tainted) or \
                        _gl005_device_call(arg):
                    hit = f"{dotted}(<tensor>)"
            if hit:
                out.append((node.lineno, (
                    f"host sync {hit} inside a loop — on a CUDA tensor "
                    f"every iteration drains the stream and pays a device "
                    f"round trip; batch the fetch outside the loop or keep "
                    f"the reduction on device (avenir_tpu_torch/models/"
                    f"tree.py::_device_select_splits pattern)")))
    return out


# ---------------------------------------------------------------------------
# GL009 — thread targets without exception routing
# ---------------------------------------------------------------------------

_GL009_BROAD = {"Exception", "BaseException"}


def _gl009_routes_exceptions(fn: ast.AST) -> bool:
    """True when the function body contains a broad try/except — the
    minimum routing discipline for code that runs on its own thread (the
    handler is expected to push the error into a queue / handshake list /
    typed shed, which review checks; this rule only catches the
    nothing-at-all class)."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Try):
            continue
        for handler in node.handlers:
            if handler.type is None:
                return True
            names = [handler.type] if not isinstance(handler.type,
                                                     ast.Tuple) \
                else list(handler.type.elts)
            for n in names:
                if isinstance(n, ast.Name) and n.id in _GL009_BROAD:
                    return True
    return False


def check_gl009(tree: ast.AST, ctx: RuleContext) -> RuleResult:
    """``threading.Thread(target=f)`` where ``f`` (resolved in this file)
    has no broad except anywhere in its body: an exception kills the
    thread silently and the joiner hangs or loses the failure.  The
    ``_handshake_errors`` class — worker threads must route failures into
    a handshake/queue/typed-shed path the spawner drains.  Test files are
    exempt (like GL008): a fixture thread that raises fails the test
    through its joined-state assertions, and pytest owns the report."""
    from avenir_tpu_torch.analysis.program import _is_test_file
    if _is_test_file(ctx.relpath):
        return []
    _attach_parents(tree)
    # symbol table: module functions + methods, by simple name
    defs: Dict[str, ast.AST] = {}
    methods: Dict[Tuple[str, str], ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, node)
            for anc in _ancestors(node):
                if isinstance(anc, ast.ClassDef):
                    methods[(anc.name, node.name)] = node
                    break
    out: RuleResult = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if (_dotted(node.func) or "").split(".")[-1] != "Thread":
            continue
        target = next((kw.value for kw in node.keywords
                       if kw.arg == "target"), None)
        if target is None:
            continue
        dotted = _dotted(target)
        fn = None
        if dotted is None:
            continue                         # lambda / call result: skip
        parts = dotted.split(".")
        if len(parts) == 1:
            fn = defs.get(parts[0])
        elif parts[0] in ("self", "cls") and len(parts) == 2:
            for anc in _ancestors(node):
                if isinstance(anc, ast.ClassDef):
                    fn = methods.get((anc.name, parts[1]))
                    break
        if fn is None:
            continue                         # cross-object target: skip
        if not _gl009_routes_exceptions(fn):
            out.append((node.lineno, (
                f"thread target {dotted}() has no broad except — an "
                f"uncaught exception kills the thread silently and the "
                f"joiner hangs or loses the failure; route errors into a "
                f"handshake/queue/typed-shed path the spawner drains "
                f"(jobs/base.py::_handshake_errors pattern)")))
    return out


# ---------------------------------------------------------------------------
# GL010 — bare ValueError/RuntimeError on conf-contract paths
# ---------------------------------------------------------------------------

_GL010_BARE = {"ValueError", "RuntimeError"}
_GL010_KEY_RE = re.compile(r"[a-z][a-z0-9_]*(?:\.[a-z0-9_]+)+")


def _gl010_message_literals(exc: ast.Call) -> str:
    """The constant text of the exception message (plain string or the
    literal parts of an f-string)."""
    if not exc.args:
        return ""
    arg = exc.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    if isinstance(arg, ast.JoinedStr):
        return "".join(v.value for v in arg.values
                       if isinstance(v, ast.Constant)
                       and isinstance(v.value, str))
    return ""


def check_gl010(tree: ast.AST, ctx: RuleContext) -> RuleResult:
    """``raise ValueError/RuntimeError`` on a conf-contract path — the
    config error contract (core/config.py::ConfigError, the
    ``shard.devices`` fix) demands the typed error so callers and the CLI
    can distinguish bad configuration from internal failures.  Fires when
    the message names a registered config key, or when the raise is
    guarded by an ``if`` over a value read from ``conf.get*()`` in the
    same function."""
    registry = ctx.config_keys if ctx.config_keys is not None \
        else _default_config_keys()
    _attach_parents(tree)
    out: RuleResult = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Raise) or \
                not isinstance(node.exc, ast.Call) or \
                not isinstance(node.exc.func, ast.Name) or \
                node.exc.func.id not in _GL010_BARE:
            continue
        kind = node.exc.func.id
        message = _gl010_message_literals(node.exc)
        named_keys = [t for t in _GL010_KEY_RE.findall(message)
                      if t in registry]
        conf_guarded = False
        fn = _enclosing_function(node)
        if fn is not None and not named_keys:
            tainted = set()
            for n in ast.walk(fn):
                if isinstance(n, ast.Assign) and \
                        isinstance(n.value, ast.Call) and \
                        isinstance(n.value.func, ast.Attribute) and \
                        n.value.func.attr in _CONF_GETTERS:
                    dotted = _dotted(n.value.func) or ""
                    receiver = dotted.rsplit(".", 1)[0].split(".")[-1]
                    if "conf" in receiver.lower() or \
                            "cfg" in receiver.lower():
                        for tgt in n.targets:
                            for t in ast.walk(tgt):
                                if isinstance(t, ast.Name):
                                    tainted.add(t.id)
            for anc in _ancestors(node):
                if anc is fn:
                    break
                if isinstance(anc, ast.If) and any(
                        isinstance(t, ast.Name) and t.id in tainted
                        for t in ast.walk(anc.test)):
                    conf_guarded = True
                    break
        if named_keys or conf_guarded:
            what = (f"names config key {named_keys[0]!r}" if named_keys
                    else "is guarded by a conf.get*() value")
            out.append((node.lineno, (
                f"bare {kind} on a conf-contract path ({what}) — raise "
                f"ConfigError (core/config.py) instead so callers and "
                f"the CLI can tell bad configuration from internal "
                f"failures (the shard.devices class); ConfigError "
                f"subclasses ValueError, so existing callers keep "
                f"working")))
    return out


# ---------------------------------------------------------------------------
# GL011 — once-per-run events emitted without the latch
# ---------------------------------------------------------------------------

def _default_event_once() -> frozenset:
    from avenir_tpu_torch.analysis.program import load_event_schema
    schema = load_event_schema()
    return frozenset(schema.once) if schema is not None else frozenset()


def check_gl011(tree: ast.AST, ctx: RuleContext) -> RuleResult:
    """A once-per-run event (telemetry/schema.py EVENT_ONCE) emitted via
    plain ``.event()`` instead of ``event_once``/a latch: restarts,
    retries, and per-chunk paths spam duplicates of records every
    consumer treats as unique (the shard.topology/fleet.join/
    tenant.admitted contract)."""
    once = ctx.event_once if ctx.event_once is not None \
        else _default_event_once()
    if not once:
        return []
    from avenir_tpu_torch.analysis.program import _emit_site
    out: RuleResult = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        site = _emit_site(node)
        if site is not None and site[0] == "event" and site[1] in once:
            out.append((node.lineno, (
                f"once-per-run event {site[1]!r} emitted with plain "
                f".event() — use tracer.event_once(..., key=...) (or an "
                f"equivalent latch) so restarts and per-chunk paths "
                f"can't journal duplicates")))
    return out


# ---------------------------------------------------------------------------
# GL012 — silently swallowed broad excepts
# ---------------------------------------------------------------------------

def check_gl012(tree: ast.AST, ctx: RuleContext) -> RuleResult:
    """``except Exception:`` (or bare ``except:``) whose body is nothing
    but ``pass``/``continue``/``break`` — the failure leaves no trace:
    no re-raise, no counter, no journal event.  Exempt when the ``try``
    body imports (optional-dependency probes are the one legitimate
    silent catch).  The review class behind the swallowed journal
    errors: a silent except turns a real failure into a debugging
    session."""
    _attach_parents(tree)
    out: RuleResult = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        probes_import = any(isinstance(n, (ast.Import, ast.ImportFrom))
                            for stmt in node.body
                            for n in ast.walk(stmt))
        if probes_import:
            continue
        for handler in node.handlers:
            broad = handler.type is None or (
                isinstance(handler.type, ast.Name)
                and handler.type.id in ("Exception", "BaseException"))
            if not broad:
                continue
            if all(isinstance(s, (ast.Pass, ast.Continue, ast.Break))
                   for s in handler.body):
                out.append((handler.lineno, (
                    f"except "
                    f"{'Exception' if handler.type is not None else ''}"
                    f" swallows silently — no re-raise, counter, or "
                    f"journal event survives the failure; record it "
                    f"(Counters / tracer.event) or re-raise, and if the "
                    f"silence is designed, say why on a graftlint "
                    f"disable comment")))
    return out


# ---------------------------------------------------------------------------

RULES: Dict[str, Callable[[ast.AST, RuleContext], RuleResult]] = {
    "GL001": check_gl001,
    "GL002": check_gl002,
    "GL003": check_gl003,
    "GL004": check_gl004,
    "GL005": check_gl005,
    "GL009": check_gl009,
    "GL010": check_gl010,
    "GL011": check_gl011,
    "GL012": check_gl012,
}

"""graftlint for the port (avenir_tpu_torch/analysis) — the JAX package's
fixture snippets carried over to the port's idioms (same rule, same
outcome), the new torch-idiom GL001/GL005 cases, the suppression /
baseline / cache mechanics and the CLI contract, parity against the JAX
package's analyzer on the JAX package's own tree, the import isolation of
the analyzer, the port's registries and key parity with the JAX package,
and the live whole-tree gate over ``avenir_tpu_torch/``, ``chip_smoke.py``
and the port's counterparts of the tests the JAX gate walks.

No torch import anywhere here: the analyzer is stdlib-only, and this file
attests that it stays importable without a device runtime.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

from avenir_tpu_torch.analysis import engine
from avenir_tpu_torch.analysis import program
from avenir_tpu_torch.analysis import registry_gen

REPO = pathlib.Path(__file__).resolve().parent.parent

# every fixture is (rule, should_fire, source), as in tests/test_analysis.py
GL001_POS = """\
from avenir_tpu_torch.parallel.mesh import all_process_sum_state

def merge_resume(path):
    text = open(path).read()          # unguarded divergent read
    return all_process_sum_state({"h": text})
"""

GL001_NEG_GUARDED = """\
from avenir_tpu_torch.parallel.mesh import all_process_sum_state, process_grid

def merge_resume(path):
    state = {}
    if process_grid()[0] == 0:
        state["h"] = open(path).read()     # writer-guarded: broadcast via
    return all_process_sum_state(state)    # the collective itself
"""

GL001_NEG_NO_SINK = """\
def local_read(path):
    return open(path).read()          # no collective in sight
"""

GL001_POS_GATHER_OBJECT = """\
import os
import torch.distributed as dist

def agree_on_dir(n):
    out = [None] * n
    dist.all_gather_object(out, os.environ.get("WORK_DIR"))
    return out
"""

GL001_POS_BROADCAST_LIST = """\
import time
import torch.distributed as dist

def share_stamp():
    box = [time.time()]               # every process's own clock
    dist.broadcast_object_list(box, src=0)
    return box[0]
"""

GL001_NEG_BROADCAST_GUARDED = """\
import time
import torch.distributed as dist

def share_stamp():
    box = [None]
    if dist.get_rank() == 0:
        box[0] = time.time()          # only the writer reads its clock
    dist.broadcast_object_list(box, src=0)
    return box[0]
"""

GL001_POS_NOT_A_GUARD = """\
from avenir_tpu_torch.parallel.mesh import all_process_sum_state

def merge_resume(path, kops, spec):
    state = {}
    if kops.rank_exact and "rank" in spec:
        state["h"] = open(path).read()     # mentions rank, guards nothing
    return all_process_sum_state(state)
"""

GL002_POS_SNAPSHOT = """\
def snapshot(mgr, acc, cur):
    mgr.save(1, {"acc": acc, "cursor": cur, "rows": 7})
"""

GL002_NEG_SNAPSHOT = """\
def snapshot(mgr, acc, cur, rid):
    mgr.save(1, {"acc": acc, "cursor": cur, "rows": 7, "run": rid})
"""

GL002_POS_KEY = """\
def accumulate(acc, chunks):
    for s, tensor in chunks:
        acc.add(f"c{s}", tensor)
"""

GL002_NEG_KEY = """\
def accumulate(acc, chunks, fingerprint):
    for s, tensor in chunks:
        acc.add(f"{fingerprint}:{s}", tensor)
"""

GL003_POS = """\
def key_for(idx):
    return f"g{idx:08d}"
"""

GL003_NEG = """\
def key_for(idx):
    if idx >= 10 ** 8:
        raise ValueError("index exceeds the 8-digit key width")
    return f"g{idx:08d}"
"""

GL004_SRC = """\
def run(conf):
    return conf.get_int("some.key", 1)
"""

GL004_NEG_DICT = """\
def run(merged):
    return merged.get("rows", 0)      # plain dict, not a JobConfig
"""

GL005_POS_FLOAT = """\
import torch

def fold(chunks):
    tot = 0.0
    for c in chunks:
        s = torch.sum(c)
        tot += float(s)               # per-chunk host sync
    return tot
"""

GL005_POS_ITEM = """\
def fold(chunks):
    tot = 0.0
    for c in chunks:
        tot += c.sum().item()
    return tot
"""

GL005_POS_SYNCHRONIZE = """\
import torch

def fold(levels, step):
    out = []
    while levels:
        out.append(step(levels.pop()))
        torch.cuda.synchronize()
    return out
"""

GL005_POS_CPU = """\
def fold(chunks, gram):
    out = []
    for c in chunks:
        out.append(gram(c).cpu())
    return out
"""

GL005_POS_NUMPY = """\
def fold(chunks, gram):
    out = []
    for c in chunks:
        out.append(gram(c).numpy())
    return out
"""

GL005_POS_TOLIST = """\
def fold(chunks, top):
    out = []
    for c in chunks:
        out.extend(top(c).tolist())
    return out
"""

GL005_POS_ASARRAY_MOVED = """\
import numpy as np

def fold(chunks, dev):
    out = []
    for c in chunks:
        t = c.to(dev)
        out.append(np.asarray(t))     # a tensor moved to the card
    return out
"""

GL005_NEG_OUTSIDE = """\
import torch

def fold(chunks):
    s = torch.sum(torch.stack(list(chunks)))
    return float(s)                   # one sync after the loop-free reduce
"""

GL005_NEG_HOST = """\
import numpy as np

def fold(chunks):
    out = []
    for c in chunks:
        s = np.sum(c)
        out.append(float(s))          # host numpy: no tensor in sight
    return out
"""

GL005_NEG_SUPPRESSED = """\
def fold(chunks, gram):
    out = []
    for c in chunks:
        # one fetch per chunk by design: the host accumulator is int64
        # graftlint: disable=GL005
        out.append(gram(c).cpu())
    return out
"""

GL005_NEG_CUDA_QUERY = """\
import torch

def sample(gauges):
    for i in range(torch.cuda.device_count()):
        in_use = torch.cuda.memory_allocated(i)
        gauges[i] = float(in_use)     # the allocator's count: a Python int
"""

GL005_NEG_OUTSIDE_METHODS = """\
def fold(chunks, gram):
    g = sum(gram(c) for c in chunks)
    return g.cpu().numpy().tolist(), g.sum().item()
"""

GL006_POS_DIRECT = """\
import threading

_lock = threading.Lock()

def flush(path, rows):
    with _lock:
        with open(path, "a") as fh:       # file I/O under a held lock
            fh.write(str(rows))
"""

GL006_NEG_DEFERRED = """\
import threading

_lock = threading.Lock()

def flush(path, rows):
    fires = []
    with _lock:
        fires.append(("tenant.throttled", {"rows": rows}))
    with open(path, "a") as fh:           # I/O after the release
        fh.write(str(rows))
"""

GL006_NEG_FILELOCK = """\
from avenir_tpu_torch.utils.locking import FileLock

def flush(path):
    lock = FileLock(path + ".lock")
    with lock:                            # cross-process file lock, not a
        with open(path, "a") as fh:       # threading lock — I/O is its job
            fh.write("x")
"""

GL009_POS = """\
import threading

def work(results):
    results.append(1 / 0)

def spawn(results):
    t = threading.Thread(target=work, args=(results,), daemon=True)
    t.start()
    return t
"""

GL009_NEG_ROUTED = """\
import threading

def work(results, errors):
    try:
        results.append(1 / 0)
    except Exception as e:
        errors.append(e)                  # routed: the spawner drains it

def spawn(results, errors):
    t = threading.Thread(target=work, args=(results, errors), daemon=True)
    t.start()
    return t
"""

GL010_POS_GUARDED = """\
def run(conf):
    path = conf.get("some.key")
    if not path:
        raise ValueError("missing input location")
"""

GL010_NEG_TYPED = """\
from avenir_tpu_torch.core.config import ConfigError

def run(conf):
    path = conf.get("some.key")
    if not path:
        raise ConfigError("missing input location")
"""

GL010_NEG_INTERNAL = """\
def check(x):
    if x < 0:
        raise ValueError("negative input")   # not a conf-contract path
"""

GL011_POS = """\
def announce(tracer, devices):
    tracer.event("shard.topology", devices=devices)
"""

GL011_NEG = """\
def announce(tracer, devices):
    tracer.event_once("shard.topology", devices=devices)
"""

GL012_POS = """\
def cleanup(sock):
    try:
        sock.close()
    except Exception:
        pass
"""

GL012_NEG_RERAISE = """\
def cleanup(sock):
    try:
        sock.close()
    except Exception:
        raise
"""

GL012_NEG_IMPORT_PROBE = """\
def maybe_accel():
    try:
        import triton
    except Exception:
        pass                              # optional-dependency probe
    else:
        return triton
    return None
"""


def lint_src(tmp_path, src, config_keys=None, name="snippet.py",
             baseline_path=None):
    f = tmp_path / name
    f.write_text(src)
    return engine.run_paths([str(f)], root=str(tmp_path),
                            baseline_path=baseline_path,
                            config_keys=config_keys)


FIXTURES = [
    ("GL001", True, GL001_POS),
    ("GL001", False, GL001_NEG_GUARDED),
    ("GL001", False, GL001_NEG_NO_SINK),
    ("GL001", True, GL001_POS_GATHER_OBJECT),
    ("GL001", True, GL001_POS_BROADCAST_LIST),
    ("GL001", False, GL001_NEG_BROADCAST_GUARDED),
    ("GL001", True, GL001_POS_NOT_A_GUARD),
    ("GL002", True, GL002_POS_SNAPSHOT),
    ("GL002", False, GL002_NEG_SNAPSHOT),
    ("GL002", True, GL002_POS_KEY),
    ("GL002", False, GL002_NEG_KEY),
    ("GL003", True, GL003_POS),
    ("GL003", False, GL003_NEG),
    ("GL005", True, GL005_POS_FLOAT),
    ("GL005", True, GL005_POS_ITEM),
    ("GL005", True, GL005_POS_SYNCHRONIZE),
    ("GL005", True, GL005_POS_CPU),
    ("GL005", True, GL005_POS_NUMPY),
    ("GL005", True, GL005_POS_TOLIST),
    ("GL005", True, GL005_POS_ASARRAY_MOVED),
    ("GL005", False, GL005_NEG_OUTSIDE),
    ("GL005", False, GL005_NEG_HOST),
    ("GL005", False, GL005_NEG_SUPPRESSED),
    ("GL005", False, GL005_NEG_OUTSIDE_METHODS),
    ("GL005", False, GL005_NEG_CUDA_QUERY),
    ("GL006", True, GL006_POS_DIRECT),
    ("GL006", False, GL006_NEG_DEFERRED),
    ("GL006", False, GL006_NEG_FILELOCK),
    ("GL009", True, GL009_POS),
    ("GL009", False, GL009_NEG_ROUTED),
    ("GL010", True, GL010_POS_GUARDED),
    ("GL010", False, GL010_NEG_TYPED),
    ("GL010", False, GL010_NEG_INTERNAL),
    ("GL011", True, GL011_POS),
    ("GL011", False, GL011_NEG),
    ("GL012", True, GL012_POS),
    ("GL012", False, GL012_NEG_RERAISE),
    ("GL012", False, GL012_NEG_IMPORT_PROBE),
]


@pytest.mark.parametrize("rule,fires,src", FIXTURES,
                         ids=[f"{r}-{'pos' if p else 'neg'}-{i}"
                              for i, (r, p, _) in enumerate(FIXTURES)])
def test_rule_fixture(tmp_path, rule, fires, src):
    found = [f for f in lint_src(tmp_path, src, config_keys={})
             if f.rule == rule]
    if fires:
        assert found, f"{rule} should fire on:\n{src}"
    else:
        assert not found, (f"{rule} must stay quiet on:\n{src}\n"
                           + "\n".join(f.format() for f in found))


# the JAX package's fixtures, each run through BOTH analyzers on its own
# idiom-free source: the same rule fires (or stays quiet) under both
_JAX_IDIOM_FREE = [(r, p, s) for r, p, s in FIXTURES
                   if r not in ("GL001", "GL005")]


@pytest.mark.parametrize("rule,fires,src", _JAX_IDIOM_FREE,
                         ids=[f"{r}-{i}" for i, (r, _, _)
                              in enumerate(_JAX_IDIOM_FREE)])
def test_idiom_free_fixture_same_verdict_as_jax(tmp_path, rule, fires, src):
    from avenir_tpu.analysis import engine as jengine

    f = tmp_path / "snippet.py"
    f.write_text(src)
    ours = [(x.rule, x.line) for x in engine.run_paths(
        [str(f)], root=str(tmp_path), baseline_path=None, config_keys={})
        if x.rule == rule]
    theirs = [(x.rule, x.line) for x in jengine.run_paths(
        [str(f)], root=str(tmp_path), baseline_path=None, config_keys={})
        if x.rule == rule]
    assert ours == theirs and bool(ours) == fires


def test_gl005_names_each_sync_and_one_line_per_call(tmp_path):
    src = """\
import torch

def fold(chunks, gram):
    out = []
    for c in chunks:
        out.append(gram(c).cpu().numpy())
        torch.cuda.synchronize()
    return out
"""
    found = sorted((f.line, f.message.split(" inside")[0])
                   for f in lint_src(tmp_path, src, config_keys={})
                   if f.rule == "GL005")
    assert found == [(6, "host sync .cpu()"), (6, "host sync .numpy()"),
                     (7, "host sync torch.cuda.synchronize()")]
    # a nested function's loop belongs to the nested function alone
    nested = """\
def outer(chunks):
    def fetch(c):
        return c.cpu()
    for c in chunks:
        fetch(c)
"""
    assert not lint_src(tmp_path, nested, config_keys={})


def test_gl001_message_points_at_the_ports_pattern(tmp_path):
    found = [f for f in lint_src(tmp_path, GL001_POS, config_keys={})
             if f.rule == "GL001"]
    assert len(found) == 1
    assert "avenir_tpu_torch/jobs/regress.py::_broadcast_resume" in \
        found[0].message
    assert "avenir_tpu/" not in found[0].message.replace(
        "avenir_tpu_torch/", "")


def test_gl004_unknown_undocumented_and_known(tmp_path):
    unknown = lint_src(tmp_path, GL004_SRC, config_keys={})
    assert [f.rule for f in unknown] == ["GL004"]
    assert "unknown config key 'some.key'" in unknown[0].message
    assert "python -m avenir_tpu_torch.analysis" in unknown[0].message

    undoc = lint_src(tmp_path, GL004_SRC, config_keys={"some.key": None})
    assert [f.rule for f in undoc] == ["GL004"]
    assert "undocumented" in undoc[0].message

    ok = lint_src(tmp_path, GL004_SRC,
                  config_keys={"some.key": "docs/jobs.md"})
    assert not ok

    assert not lint_src(tmp_path, GL004_NEG_DICT, config_keys={})


def test_registry_generator_roundtrip(tmp_path):
    (tmp_path / "mod.py").write_text(
        "def run(conf):\n"
        "    return conf.get('a.b'), conf.get_bool('c.d')\n")
    (tmp_path / "test_mod.py").write_text(
        "def test_run(conf):\n"
        "    assert conf.get('fixture.only')\n")
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "ref.md").write_text(
        "Keys: `a.b` (a thing), and fenced blocks must not desync:\n"
        "```\nconf `not.this` stuff\n```\n`-Dc.d=true` works too.\n")
    out = tmp_path / "registry.py"
    registry = registry_gen.write_registry(
        [str(tmp_path / "mod.py"), str(tmp_path / "test_mod.py")],
        [str(docs)], root=str(tmp_path), out_path=str(out))
    # test files read fixture keys: they never enter the registry
    assert registry == {"a.b": "docs/ref.md", "c.d": "docs/ref.md"}
    ns: dict = {}
    exec(out.read_text(), ns)                 # the generated file is valid
    assert ns["CONFIG_KEYS"] == registry


def _default_code_paths():
    from avenir_tpu_torch.analysis.__main__ import DEFAULT_PATHS

    assert DEFAULT_PATHS == ("avenir_tpu_torch", "chip_smoke.py")
    return [str(REPO / p) for p in DEFAULT_PATHS]


def test_config_registry_matches_tree():
    from avenir_tpu_torch.analysis.config_registry import CONFIG_KEYS

    code = registry_gen.scan_code_keys(_default_code_paths())
    assert sorted(code) == sorted(CONFIG_KEYS), (
        "config_registry.py is stale — run "
        "`python -m avenir_tpu_torch.analysis --write-registry`")
    undocumented = sorted(k for k, v in CONFIG_KEYS.items() if v is None)
    assert not undocumented, f"undocumented config keys: {undocumented}"


def test_counter_registry_matches_tree():
    from avenir_tpu_torch.analysis.counter_registry import (COUNTER_GROUPS,
                                                            SPAN_SITES)
    groups, spans = registry_gen.scan_counter_span_sites(
        _default_code_paths())
    assert sorted(groups) == sorted(COUNTER_GROUPS) and \
        sorted(spans) == sorted(SPAN_SITES), (
        "counter_registry.py is stale — run "
        "`python -m avenir_tpu_torch.analysis --write-registry`")
    undocumented = sorted(k for k, v in {**COUNTER_GROUPS,
                                         **SPAN_SITES}.items() if v is None)
    assert not undocumented, f"undocumented groups / spans: {undocumented}"


def test_port_reads_exactly_the_jax_packages_conf_keys():
    """Key parity: every ``conf.get*("…")`` literal the JAX package reads,
    the port reads, and no other — a key the port never reads is a
    silently ignored key (``pool.pin.devices`` was one)."""
    from avenir_tpu.analysis import registry_gen as jax_registry_gen

    ours = registry_gen.scan_code_keys([str(REPO / "avenir_tpu_torch")])
    theirs = jax_registry_gen.scan_code_keys([str(REPO / "avenir_tpu")])
    assert sorted(set(theirs) - set(ours)) == []
    assert sorted(set(ours) - set(theirs)) == []
    assert "pool.pin.devices" in ours


# -- suppression / baseline mechanics ------------------------------------

def test_suppression_same_line_and_line_above(tmp_path):
    inline = GL005_POS_ITEM.replace(
        "tot += c.sum().item()",
        "tot += c.sum().item()  # graftlint: disable=GL005")
    assert not lint_src(tmp_path, inline, config_keys={})

    above = GL005_POS_ITEM.replace(
        "        tot += c.sum().item()",
        "        # graftlint: disable=GL005\n"
        "        tot += c.sum().item()")
    assert not lint_src(tmp_path, above, config_keys={})

    # suppressing a DIFFERENT rule must not hide the finding
    wrong = GL005_POS_ITEM.replace(
        "tot += c.sum().item()",
        "tot += c.sum().item()  # graftlint: disable=GL003")
    assert [f.rule for f in lint_src(tmp_path, wrong, config_keys={})] \
        == ["GL005"]


def test_suppression_file_wide(tmp_path):
    src = "# graftlint: disable-file=GL003\n" + GL003_POS
    assert not lint_src(tmp_path, src, config_keys={})
    # only in the first 20 lines
    late = "\n" * 25 + "# graftlint: disable-file=GL003\n" + GL003_POS
    assert [f.rule for f in lint_src(tmp_path, late, config_keys={})] \
        == ["GL003"]


def test_project_rule_suppression(tmp_path):
    src = GL006_POS_DIRECT.replace(
        "        with open(path, \"a\") as fh:       # file I/O under a "
        "held lock",
        "        # graftlint: disable=GL006\n"
        "        with open(path, \"a\") as fh:")
    assert "disable=GL006" in src
    assert not [f for f in lint_src(tmp_path, src, config_keys={})
                if f.rule == "GL006"]


def test_baseline_pass_and_new_finding_fails(tmp_path):
    """The three-way contract: suppressed line → pass, baselined legacy
    finding → pass, NEW finding → fail."""
    live = lint_src(tmp_path, GL003_POS, config_keys={},
                    name="legacy.py")
    assert len(live) == 1 and not live[0].baselined

    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps({"findings": [
        {"rule": live[0].rule, "path": live[0].path,
         "message": live[0].message, "why": "grandfathered for the test"}
    ]}))
    again = lint_src(tmp_path, GL003_POS, config_keys={},
                     name="legacy.py", baseline_path=str(bl))
    assert len(again) == 1 and again[0].baselined

    fresh = lint_src(tmp_path, GL003_POS, config_keys={},
                     name="fresh.py", baseline_path=str(bl))
    assert len(fresh) == 1 and not fresh[0].baselined


def test_write_baseline_preserves_existing_whys(tmp_path):
    (tmp_path / "legacy.py").write_text(GL003_POS)
    (tmp_path / "fresh.py").write_text(GL003_POS)
    bl = tmp_path / "baseline.json"
    legacy = lint_src(tmp_path, GL003_POS, config_keys={},
                      name="legacy.py")[0]
    bl.write_text(json.dumps({"findings": [
        {"rule": legacy.rule, "path": legacy.path,
         "message": legacy.message, "why": "curated reason"}]}))
    findings = engine.run_paths(
        [str(tmp_path / "legacy.py"), str(tmp_path / "fresh.py")],
        root=str(tmp_path), baseline_path=str(bl), config_keys={})
    engine.write_baseline(str(bl), findings,
                          existing=engine.load_baseline(str(bl)))
    merged = json.loads(bl.read_text())["findings"]
    whys = {e["path"]: e["why"] for e in merged}
    assert whys["legacy.py"] == "curated reason"
    assert "FILL ME IN" in whys["fresh.py"]


def test_baseline_requires_why(tmp_path):
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps({"findings": [
        {"rule": "GL003", "path": "x.py", "message": "m", "why": ""}]}))
    with pytest.raises(ValueError, match="why"):
        engine.load_baseline(str(bl))


def test_checked_in_baseline_and_suppressions_carry_reasons():
    """Every grandfathered finding says why (load_baseline enforces it),
    and every suppression comment in the port's tree has a reason: a
    comment on its own line or the line above, or text after the rule."""
    engine.load_baseline(engine.BASELINE_PATH)
    bare = []
    for path in engine._iter_py_files(_default_code_paths()):
        lines = open(path, encoding="utf-8").read().splitlines()
        for i, line in enumerate(lines):
            if "graftlint: disable" not in line or "analysis" in path:
                continue
            prev = lines[i - 1].strip() if i else ""
            code = line.split("#", 1)[0].strip()
            if not (code or prev.startswith("#")):
                bare.append(f"{path}:{i + 1}")
    assert not bare, f"suppressions without a reason: {bare}"


def test_syntax_error_reports_gl000(tmp_path):
    findings = lint_src(tmp_path, "def broken(:\n", config_keys={})
    assert [f.rule for f in findings] == ["GL000"]


# -- the whole-program pass (GL006/GL007/GL008) ---------------------------

def _mini_schema(tmp_path, events=("known.event",), once=()):
    p = tmp_path / "mini_schema.py"
    p.write_text(
        "GOLDEN_EVENT_KEYS = {\n"
        + "".join(f'    "{e}": ("ev", "ts"),\n' for e in events)
        + "}\n"
        + f"EVENT_ONCE = {set(once)!r}\n")
    return program.load_event_schema(str(p), explicit=True)


def test_event_schema_path_is_the_ports():
    assert pathlib.Path(program.EVENT_SCHEMA_PATH) == \
        REPO / "avenir_tpu_torch" / "telemetry" / "schema.py"
    schema = program.load_event_schema()
    assert "span.open" in schema.names
    assert schema.once == {"shard.topology", "fleet.join",
                           "tenant.admitted"}


def test_gl006_cross_file_reachability(tmp_path):
    (tmp_path / "iohelp.py").write_text(
        "def persist(path):\n"
        "    with open(path, 'a') as fh:\n"
        "        fh.write('x')\n")
    (tmp_path / "hot.py").write_text(
        "import threading\n"
        "from iohelp import persist\n"
        "\n"
        "_lock = threading.Lock()\n"
        "\n"
        "def flush(path):\n"
        "    with _lock:\n"
        "        persist(path)\n")
    findings = engine.run_paths([str(tmp_path)], root=str(tmp_path),
                                baseline_path=None, config_keys={})
    gl6 = [f for f in findings if f.rule == "GL006"]
    assert [f.path for f in gl6] == ["hot.py"], \
        "\n".join(f.format() for f in findings)
    assert "iohelp.py::persist" in gl6[0].message


def test_gl007_unknown_event_and_liveness(tmp_path):
    schema = _mini_schema(tmp_path, events=("known.event",))
    (tmp_path / "emit.py").write_text(
        'def go(tracer):\n'
        '    tracer.event("zorp.mystery", x=1)\n')
    findings = engine.run_paths([str(tmp_path / "emit.py")],
                                root=str(tmp_path), baseline_path=None,
                                config_keys={}, event_schema=schema)
    gl7 = [f for f in findings if f.rule == "GL007"]
    assert any("'zorp.mystery'" in f.message and f.path == "emit.py"
               for f in gl7), "\n".join(f.format() for f in gl7)
    assert any("'known.event'" in f.message and "no live emit site"
               in f.message for f in gl7)


def test_gl007_literal_emit_and_deferred_tuple_both_count_live(tmp_path):
    schema = _mini_schema(tmp_path, events=("known.event",))
    (tmp_path / "emit.py").write_text(
        'def go(tracer, fires):\n'
        '    fires.append(("known.event", {"x": 1}))\n')
    findings = engine.run_paths([str(tmp_path / "emit.py")],
                                root=str(tmp_path), baseline_path=None,
                                config_keys={}, event_schema=schema)
    assert not [f for f in findings if f.rule == "GL007"], \
        "\n".join(f.format() for f in findings)


def test_gl007_seeded_schema_drift_fires_on_the_ports_tree(tmp_path):
    """Mutate a copy of the port's golden schema (span.open → span.opened)
    and prove the cross-file pass catches both drift directions over the
    port's live tree."""
    real = (REPO / "avenir_tpu_torch" / "telemetry" / "schema.py"
            ).read_text()
    assert real.count('"span.open"') == 1
    mutated = tmp_path / "mutated_schema.py"
    mutated.write_text(real.replace('"span.open"', '"span.opened"'))
    schema = program.load_event_schema(str(mutated), explicit=True)
    tree = _default_code_paths()
    gl7 = [f for f in engine.run_paths(tree, root=str(REPO),
                                       baseline_path=None,
                                       rules={"GL007": None},
                                       event_schema=schema)
           if f.rule == "GL007"]
    assert any("'span.open'" in f.message
               and f.path == "avenir_tpu_torch/telemetry/spans.py"
               for f in gl7), "\n".join(f.format() for f in gl7)
    assert any("'span.opened'" in f.message and "no live emit site"
               in f.message for f in gl7)


def test_gl008_unknown_undocumented_and_wildcard(tmp_path):
    src = (
        "def count(counters, model):\n"
        '    counters.increment("Zorp", "n")\n'
        '    counters.increment(f"Serving.{model}", "n")\n')
    (tmp_path / "mod.py").write_text(src)

    def run(reg):
        return [f for f in engine.run_paths(
            [str(tmp_path / "mod.py")], root=str(tmp_path),
            baseline_path=None, config_keys={}, counter_registry=reg)
            if f.rule == "GL008"]

    both = run({"groups": {}, "spans": {}})
    assert len(both) == 2
    assert all("python -m avenir_tpu_torch.analysis" in f.message
               for f in both)
    undoc = run({"groups": {"Zorp": None, "Serving.*": "docs/a.md"},
                 "spans": {}})
    assert len(undoc) == 1 and "Zorp" in undoc[0].message
    clean = run({"groups": {"Zorp": "docs/a.md", "Serving.*": "docs/a.md"},
                 "spans": {}})
    assert not clean
    (tmp_path / "test_mod.py").write_text(src)
    assert not [f for f in engine.run_paths(
        [str(tmp_path / "test_mod.py")], root=str(tmp_path),
        baseline_path=None, config_keys={},
        counter_registry={"groups": {}, "spans": {}})
        if f.rule == "GL008"]


# -- facts cache + incremental (--changed) mechanics ----------------------

def test_cache_warm_hits_and_salt_invalidation(tmp_path):
    (tmp_path / "a.py").write_text(GL003_NEG)
    (tmp_path / "b.py").write_text(GL003_NEG)
    cache = tmp_path / "cache.json"

    def run(config_keys={}):
        stats: dict = {}
        findings = engine.run_paths(
            [str(tmp_path / "a.py"), str(tmp_path / "b.py")],
            root=str(tmp_path), baseline_path=None,
            config_keys=config_keys, cache_path=str(cache), stats=stats)
        return findings, stats

    _, cold = run()
    assert cold["files"] == 2 and cold["cache_hits"] == 0
    _, warm = run()
    assert warm["cache_hits"] == 2
    _, salted = run(config_keys={"some.key": "docs/x.md"})
    assert salted["cache_hits"] == 0


def test_cache_salt_is_the_ports_own():
    """The two analyzers salt their caches with their own sources, so
    they must write different cache files or evict each other's."""
    from avenir_tpu.analysis import __main__ as jax_main
    from avenir_tpu.analysis import engine as jax_engine
    from avenir_tpu_torch.analysis import __main__ as our_main

    assert our_main.CACHE_PATH != jax_main.CACHE_PATH
    assert engine.cache_salt({}, frozenset()) != \
        jax_engine.cache_salt({}, frozenset())
    ignored = (REPO / ".gitignore").read_text().split()
    assert our_main.CACHE_PATH in ignored


def test_changed_set_trusts_git_over_disk(tmp_path):
    b = tmp_path / "b.py"
    (tmp_path / "a.py").write_text(GL003_NEG)
    b.write_text(GL003_NEG)
    cache = tmp_path / "cache.json"

    def run(changed=None):
        return engine.run_paths(
            [str(tmp_path / "a.py"), str(b)], root=str(tmp_path),
            baseline_path=None, config_keys={}, cache_path=str(cache),
            changed=changed)

    assert not [f for f in run() if f.rule == "GL003"]
    b.write_text(GL003_POS)
    assert not [f for f in run(changed=set()) if f.rule == "GL003"]
    hot = [f for f in run(changed={"b.py"}) if f.rule == "GL003"]
    assert [f.path for f in hot] == ["b.py"]


# -- CLI contract ---------------------------------------------------------

def _run_cli(args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "avenir_tpu_torch.analysis", *args],
        cwd=cwd, capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})


def test_cli_findings_format_and_exit_code(tmp_path):
    (tmp_path / "bad.py").write_text(GL003_POS)
    res = _run_cli(["bad.py", "--no-baseline"], cwd=str(tmp_path))
    assert res.returncode == 1
    assert res.stdout.startswith("bad.py:2: GL003 ")
    assert "graftlint: 1 finding(s)" in res.stderr

    res_json = _run_cli(["bad.py", "--no-baseline", "--json"],
                        cwd=str(tmp_path))
    payload = json.loads(res_json.stdout)
    assert payload[0]["rule"] == "GL003" and payload[0]["path"] == "bad.py"


def test_cli_clean_exits_zero_and_stats_cache(tmp_path):
    (tmp_path / "ok.py").write_text(GL003_NEG)
    cold = _run_cli(["ok.py", "--stats"], cwd=str(tmp_path))
    assert cold.returncode == 0, cold.stdout + cold.stderr
    assert "graftlint stats: 1 files" in cold.stderr
    assert "0 cache hits" in cold.stderr
    assert (tmp_path / ".graftlint-torch-cache.json").exists()
    warm = _run_cli(["ok.py", "--stats"], cwd=str(tmp_path))
    assert "1 cache hits" in warm.stderr
    uncached = _run_cli(["ok.py", "--stats", "--no-cache"],
                        cwd=str(tmp_path))
    assert "0 cache hits" in uncached.stderr


def test_cli_show_baselined_and_write_baseline(tmp_path):
    (tmp_path / "bad.py").write_text(GL003_POS)
    bl = tmp_path / "bl.json"
    wrote = _run_cli(["bad.py", "--baseline", str(bl), "--write-baseline"],
                     cwd=str(tmp_path))
    assert wrote.returncode == 0 and "1 new entry" in wrote.stdout
    entries = json.loads(bl.read_text())["findings"]
    assert "FILL ME IN" in entries[0]["why"]
    entries[0]["why"] = "grandfathered for the test"
    bl.write_text(json.dumps({"findings": entries}))
    quiet = _run_cli(["bad.py", "--baseline", str(bl)], cwd=str(tmp_path))
    assert quiet.returncode == 0 and quiet.stdout == ""
    shown = _run_cli(["bad.py", "--baseline", str(bl), "--show-baselined"],
                     cwd=str(tmp_path))
    assert shown.returncode == 0 and "[baselined]" in shown.stdout


def test_cli_changed_outside_git_falls_back_to_full_run(tmp_path):
    (tmp_path / "bad.py").write_text(GL003_POS)
    res = _run_cli(["bad.py", "--changed", "--no-baseline"],
                   cwd=str(tmp_path))
    assert res.returncode == 1
    assert "GL003" in res.stdout


def test_cli_default_paths_need_the_repo_root(tmp_path):
    res = _run_cli([], cwd=str(tmp_path))
    assert res.returncode == 2
    assert "avenir_tpu_torch" in res.stderr


def test_cli_check_registry_up_to_date():
    res = _run_cli(["--check-registry"], cwd=str(REPO))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "registries up to date" in res.stdout


def test_import_pulls_in_neither_torch_jax_nor_the_jax_package():
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, avenir_tpu_torch.analysis, "
         "avenir_tpu_torch.analysis.__main__; "
         "from avenir_tpu_torch.analysis import engine; "
         "engine.run_paths(['avenir_tpu_torch/analysis'], "
         "baseline_path=None); "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('torch', 'jax', 'avenir_tpu', 'numpy')))"],
        cwd=str(REPO), capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


# -- parity with the JAX package's analyzer, on its own tree --------------

_IDIOM_FREE_RULES = {"GL002", "GL003", "GL004", "GL006", "GL007", "GL008",
                     "GL009", "GL010", "GL011", "GL012"}
# the one part of a message that differs between the analyzers by design:
# the parenthesised bug-class citation ("(... class)"), which names the
# history in each package's own words
_CLASS_TAG = re.compile(r"\([^()]*\bclass\)")


def test_parity_with_the_jax_analyzer_on_the_jax_tree(tmp_path):
    """Both engines over ``avenir_tpu``, ``benchmarks`` and ``bench.py``,
    each given the JAX package's config registry, counter registry, event
    schema and baseline through ``run_paths``' seams: the (rule, path,
    line, baselined) sets are equal for every idiom-free rule."""
    from avenir_tpu.analysis import engine as jengine
    from avenir_tpu.analysis import program as jprogram
    from avenir_tpu.analysis.config_registry import CONFIG_KEYS
    from avenir_tpu.analysis.counter_registry import (COUNTER_GROUPS,
                                                      SPAN_SITES)

    tree = [str(REPO / "avenir_tpu"), str(REPO / "benchmarks"),
            str(REPO / "bench.py")]
    schema_path = str(REPO / "avenir_tpu" / "telemetry" / "schema.py")
    counters = {"groups": dict(COUNTER_GROUPS), "spans": dict(SPAN_SITES)}
    theirs = jengine.run_paths(
        tree, root=str(REPO), baseline_path=jengine.BASELINE_PATH,
        config_keys=dict(CONFIG_KEYS),
        event_schema=jprogram.load_event_schema(schema_path),
        counter_registry=counters)

    # the JAX baseline, its class citations in the port's words
    cache = str(tmp_path / "cache.json")
    seams = dict(root=str(REPO), config_keys=dict(CONFIG_KEYS),
                 event_schema=program.load_event_schema(schema_path),
                 counter_registry=counters, cache_path=cache)
    raw = engine.run_paths(tree, baseline_path=None, **seams)
    entries = json.loads(pathlib.Path(jengine.BASELINE_PATH).read_text())
    translated = []
    for e in entries["findings"]:
        words = {f.message for f in raw
                 if (f.rule, f.path) == (e["rule"], e["path"])
                 and _CLASS_TAG.sub("()", f.message)
                 == _CLASS_TAG.sub("()", e["message"])}
        assert len(words) == 1, e
        translated.append(dict(e, message=words.pop()))
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps({"findings": translated}))
    ours = engine.run_paths(tree, baseline_path=str(bl), **seams)

    def key(findings):
        return {(f.rule, f.path, f.line, f.baselined) for f in findings
                if f.rule in _IDIOM_FREE_RULES}

    assert key(ours) == key(theirs)
    assert any(baselined for *_, baselined in key(ours))
    # the messages agree outside the class citation
    assert {(f.rule, f.path, f.line, _CLASS_TAG.sub("()", f.message))
            for f in ours if f.rule in _IDIOM_FREE_RULES - {"GL004",
                                                             "GL008"}} == \
        {(f.rule, f.path, f.line, _CLASS_TAG.sub("()", f.message))
         for f in theirs if f.rule in _IDIOM_FREE_RULES - {"GL004",
                                                            "GL008"}}


# -- the live gate: the port's whole tree ---------------------------------

# the port's counterparts of the tests the JAX package's gate walks
# (tests/test_analysis.py::test_whole_tree_zero_nonbaselined_findings)
GATED_TESTS = (
    "test_torch_serving.py", "test_torch_telemetry.py",
    "test_torch_stream.py", "test_torch_shard.py", "test_torch_tree.py",
    "test_torch_profile.py", "test_torch_fleet.py", "torch_fleet_worker.py",
    "test_torch_reshard.py", "test_torch_pool.py", "test_torch_tenancy.py",
    "test_torch_multiprocess.py", "test_torch_plan.py",
    "test_torch_globalserve.py", "test_torch_resp.py",
)


def test_whole_tree_zero_nonbaselined_findings():
    """graftlint is the port's tier-1 gate: ``avenir_tpu_torch/``,
    ``chip_smoke.py`` and the gated tests carry zero non-baselined
    findings, and every baseline entry still matches a finding."""
    paths = _default_code_paths() + [str(REPO / "tests" / t)
                                     for t in GATED_TESTS]
    assert all(os.path.exists(p) for p in paths)
    findings = engine.run_paths(paths, root=str(REPO))
    live = [f for f in findings if not f.baselined]
    assert not live, (
        "graftlint found new hazards (fix them, suppress with a "
        "why-comment, or — for legacy findings only — baseline them):\n"
        + "\n".join(f.format() for f in live))
    matched = {f.key for f in findings if f.baselined}
    stale = [e for e in engine.load_baseline(engine.BASELINE_PATH)
             if (e["rule"], e["path"], e["message"]) not in matched]
    assert not stale, f"baseline entries no longer match any finding: {stale}"

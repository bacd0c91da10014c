"""The chombo jobs of the port held against ``avenir_tpu`` on the CPU:
the registry's names, Projection and RunningAggregator (part files
byte-identical), and NumericalAttrStats whole and streamed, conditioned
and not: byte-identical on float32-exact data (values on a dyadic grid
whose per-group and per-chunk means are dyadic), elsewhere count, min
and max equal as strings and the moment fields within rtol 1e-5 (the
port sums the moments in float64, the JAX package in float32); large
magnitudes, nan/inf, the state cap and the checkpoint-dir refusal with
the JAX package's text."""

import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from avenir_tpu.__main__ import main as jax_main  # noqa: E402
from avenir_tpu.core.config import ConfigError as JConfigError  # noqa: E402
from avenir_tpu.core.config import JobConfig as JConfig  # noqa: E402
from avenir_tpu.jobs import JOB_CLASSES as J_JOB_CLASSES  # noqa: E402
from avenir_tpu.jobs import get_job as j_get_job  # noqa: E402
from avenir_tpu_torch.__main__ import main as torch_main  # noqa: E402
from avenir_tpu_torch.core.config import ConfigError, JobConfig  # noqa: E402
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)
from avenir_tpu_torch.jobs import JOB_CLASSES, REGISTRY, get_job  # noqa: E402

RTOL = 1e-5


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _both(tmp_path, job, props, data, name="out"):
    """(torch part file, torch stdout), (jax part file, jax stdout)."""
    outs = {}
    for pkg, main, extra in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", "cpu"])):
        out = tmp_path / f"{pkg}_{name}"
        text = _run(main, [job, *props, str(data), str(out), *extra])
        outs[pkg] = ((out / "part-00000").read_text(), text)
    return outs["torch"], outs["jax"]


def test_registry_names():
    """All 29 job classes of the JAX package's list (StreamAnalytics
    included, which ``stream/job.py`` appends to it in both packages),
    each by its simple and its reference name."""
    assert len(JOB_CLASSES) == 29
    assert {c.name for c in J_JOB_CLASSES} == {c.name for c in JOB_CLASSES}
    assert REGISTRY["StreamAnalytics"].name == "StreamAnalytics"
    for name in ("RunningAggregator", "Projection", "NumericalAttrStats"):
        assert REGISTRY[name] is REGISTRY[f"org.chombo.mr.{name}"]
    for name in ("GreedyRandomBandit", "AuerDeterministic", "SoftMaxBandit",
                 "RandomFirstGreedyBandit"):
        assert REGISTRY[name] is REGISTRY[f"org.avenir.reinforce.{name}"]
    assert REGISTRY["WordCounter"] is REGISTRY["org.avenir.text.WordCounter"]
    listed = _run(torch_main, ["--list"]).split()
    assert len(listed) == 29 and "NumericalAttrStats" in listed
    assert "StreamAnalytics" in listed
    assert "ScoringPlane" in listed


@pytest.mark.parametrize("job", ["RunningAggregator", "Projection",
                                 "NumericalAttrStats"])
def test_chombo_jobs_need_cuda_or_cpu(tmp_path, job):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    (tmp_path / "in.csv").write_text("a,b,1,2\n")
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_main([f"org.chombo.mr.{job}", str(tmp_path / "in.csv"),
                    str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


# ---------------------------------------------------------------------------
# Projection and RunningAggregator
# ---------------------------------------------------------------------------

def _xactions(n, seed):
    rng = np.random.default_rng(seed)
    return [f"c{rng.integers(0, 40):03d},{1000 + i},2013-{rng.integers(1, 13):02d}-"
            f"{rng.integers(1, 29):02d},{rng.integers(5, 300)}" for i in range(n)]


@pytest.mark.parametrize("props", [
    ["-Dprojection.key.field=0", "-Dprojection.field.ordinals=2,3",
     "-Dprojection.sort.field=2"],
    ["-Dprojection.key.field=0"],
    ["-Dprojection.key.field=3", "-Dprojection.field.ordinals=0",
     "-Dprojection.sort.field=1"],
])
def test_projection_byte_identical(tmp_path, props):
    (tmp_path / "in").mkdir()
    rows = _xactions(1200, 1)
    (tmp_path / "in" / "a.txt").write_text("\n".join(rows[:700]) + "\n")
    (tmp_path / "in" / "b.txt").write_text("\n".join(rows[700:]) + "\n")
    (tmp_path / "in" / "_SUCCESS").write_text("")
    got, want = _both(tmp_path, "org.chombo.mr.Projection", props,
                      tmp_path / "in")
    assert got == want
    assert "Rows=1200" in got[1]


def test_running_aggregator_byte_identical(tmp_path):
    """A running state, two incremental files (one with a custom quantity
    column) and fractional sums."""
    rng = np.random.default_rng(2)
    (tmp_path / "in").mkdir()
    keys = [(f"p{g}", str(10 + 2 * i)) for g in range(30) for i in range(6)]
    (tmp_path / "in" / "agg.txt").write_text("".join(
        f"{g},{i},{c},{c * 1.37:.3f},{1.37 if c else 0}\n"
        for (g, i), c in zip(keys, rng.integers(0, 9, len(keys)))))
    for r in (1, 2):
        picks = rng.integers(0, len(keys), 150)
        (tmp_path / "in" / f"round_{r}.txt").write_text("".join(
            f"{keys[k][0]},{keys[k][1]},x,{rng.normal(500, 80):.3f}\n"
            for k in picks))
    props = ["-Dincremental.file.prefix=round", "-Dquantity.attr=3"]
    got, want = _both(tmp_path, "org.chombo.mr.RunningAggregator", props,
                      tmp_path / "in")
    assert got == want
    assert "IncrementalRows=300" in got[1]


# ---------------------------------------------------------------------------
# NumericalAttrStats
# ---------------------------------------------------------------------------

def _exact_rows(n_pairs, seed, one_mean=False):
    """Rows ``x,group,y`` in consecutive pairs m ± d of one group: x and y on
    a grid of 1/4, so every group's (and every even-sized chunk's) mean is
    on the grid and the float32 sums of the shifted values and their
    squares are exact.  ``one_mean``: every group about the same means, so
    that the unconditioned mean is on the grid too."""
    rng = np.random.default_rng(seed)
    means = {"a": (3.25, -1.5), "b": (-20.75, 4.0), "c": (0.0, 1000.5)}
    if one_mean:
        means = dict.fromkeys(means, means["b"])
    rows = []
    for _ in range(n_pairs):
        g = "abc"[rng.integers(0, 3)]
        dx, dy = rng.integers(-32, 33, 2) / 4
        for s in (1, -1):
            rows.append(f"{means[g][0] + s * dx},{g},{means[g][1] + s * dy}")
    return rows


def _loose_rows(n, seed, base=(3.0, -2.0)):
    rng = np.random.default_rng(seed)
    return [f"{rng.normal(base[0], 1.0):.5f},{'abc'[rng.integers(0, 3)]},"
            f"{rng.normal(base[1], 0.7):.5f}" for _ in range(n)]


def _close(got: str, want: str) -> float:
    """count, min and max equal as strings, the moments within RTOL;
    returns the largest relative gap."""
    g_lines, w_lines = got.splitlines(), want.splitlines()
    assert len(g_lines) == len(w_lines) and g_lines
    worst = 0.0
    for gl, wl in zip(g_lines, w_lines):
        gf, wf = gl.split(","), wl.split(",")
        assert gf[:-8] == wf[:-8]                    # attr [, cond]
        assert gf[-8] == wf[-8]                      # count
        assert gf[-2:] == wf[-2:]                    # min, max
        g, w = (np.array([float(v) for v in f[-7:-2]]) for f in (gf, wf))
        np.testing.assert_allclose(g, w, rtol=RTOL)
        nz = w != 0
        worst = max(worst, float(np.max(np.abs(g - w)[nz] / np.abs(w)[nz],
                                        initial=0.0)))
    return worst


@pytest.mark.parametrize("cond", [True, False])
@pytest.mark.parametrize("chunk", [None, "96", "250"])
def test_numerical_attr_stats_exact_data_byte_identical(tmp_path, cond, chunk):
    (tmp_path / "d.txt").write_text(
        "\n".join(_exact_rows(700, 3, one_mean=not cond)) + "\n")
    props = ["-Dattr.list=0,2"] + (["-Dcond.attr.ord=1"] if cond else [])
    props += [f"-Dstream.chunk.rows={chunk}"] if chunk else []
    got, want = _both(tmp_path, "org.chombo.mr.NumericalAttrStats", props,
                      tmp_path / "d.txt")
    assert got == want
    assert len(got[0].splitlines()) == (6 if cond else 2)


@pytest.mark.parametrize("cond", [True, False])
@pytest.mark.parametrize("chunk", [None, "97"])
@pytest.mark.parametrize("base", [(3.0, -2.0), (1.0e7, -5.0e5)])
def test_numerical_attr_stats_float_data_close(tmp_path, cond, chunk, base):
    """Continuous data (and |mean| >> std): the port's float64 moments
    within RTOL of the JAX package's float32 ones."""
    (tmp_path / "d.txt").write_text("\n".join(_loose_rows(1500, 4, base)) + "\n")
    props = ["-Dattr.list=0,2"] + (["-Dcond.attr.ord=1"] if cond else [])
    props += [f"-Dstream.chunk.rows={chunk}"] if chunk else []
    got, want = _both(tmp_path, "org.chombo.mr.NumericalAttrStats", props,
                      tmp_path / "d.txt")
    assert got[1] == want[1]
    _close(got[0], want[0])


def test_numerical_attr_stats_schema_attrs(tmp_path):
    """Without attr.list the numeric schema features are taken, whole and
    streamed.  Hospital columns are integers whose group means are not on a
    grid, so the shifted values round to float32 in both packages (a sum
    of 43503 prints as 43503.0000510216): the fields agree within RTOL."""
    from avenir_tpu_torch.core.csv_io import write_csv

    write_csv(str(tmp_path / "h.csv"), generate_hosp_readmit(1200, seed=5))
    (tmp_path / "h.json").write_text(json.dumps(HOSP_SCHEMA_JSON))
    for extra in ([], ["-Dstream.chunk.rows=300"]):
        props = [f"-Dfeature.schema.file.path={tmp_path / 'h.json'}",
                 "-Dcond.attr.ord=11", *extra]
        got, want = _both(tmp_path, "NumericalAttrStats", props,
                          tmp_path / "h.csv", name=f"o{len(extra)}")
        assert got[1] == want[1]
        _close(got[0], want[0])


@pytest.mark.parametrize("text", ["1.5\nnan\n2.5\n", "1.5\ninf\n2.5\n",
                                  "-inf\n4\n2\n", "7\n"])
def test_numerical_attr_stats_nonfinite_equal_jax(tmp_path, text):
    (tmp_path / "d.txt").write_text(text)
    for extra in ([], ["-Dstream.chunk.rows=2"]):
        got, want = _both(tmp_path, "NumericalAttrStats",
                          ["-Dattr.list=0", *extra], tmp_path / "d.txt",
                          name=f"o{len(extra)}")
        assert got == want


def test_numerical_attr_stats_state_cap_and_refusals(tmp_path):
    """The O(chunks × groups) state cap, the checkpoint-dir refusal and the
    missing attribute list raise ConfigError with the JAX package's text."""
    (tmp_path / "d.txt").write_text("\n".join(_loose_rows(600, 9)) + "\n")
    cases = [
        {"attr.list": "0,2", "cond.attr.ord": "1", "stream.chunk.rows": "50",
         "stream.stats.max.state.mb": "0"},
        {"attr.list": "0,2", "stream.chunk.rows": "50",
         "stream.checkpoint.dir": str(tmp_path / "ck")},
        {"stream.chunk.rows": "50"},
    ]
    for props in cases:
        with pytest.raises(JConfigError) as jerr:
            j_get_job("NumericalAttrStats").run(
                JConfig(dict(props)), str(tmp_path / "d.txt"),
                str(tmp_path / "jout"))
        with pytest.raises(ConfigError) as err:
            get_job("NumericalAttrStats").run(
                JobConfig(dict(props)), str(tmp_path / "d.txt"),
                str(tmp_path / "tout"), device="cpu")
        assert str(err.value) == str(jerr.value)
    assert not (tmp_path / "tout").exists()
    assert not (tmp_path / "ck").exists()

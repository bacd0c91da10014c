"""The bandit family of the port held against ``avenir_tpu`` on the CPU:
``prng.gumbel`` (uniform bits equal, values within abs 1e-6) and
``prng.categorical`` (indices equal), the three selection functions and
the four bandit classes on seeded states with ragged groups and untried
arms (selections equal), ``GroupState`` and ``BanditJob``, the four
bandit jobs through both CLIs (part files byte-identical), and the
tutorial's price-optimisation round loop (every round's selection and
aggregate files byte-identical, converging as the JAX package's own loop
test asserts)."""

import contextlib
import io
import shutil

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

from avenir_tpu.__main__ import main as jax_main  # noqa: E402
from avenir_tpu.core.config import JobConfig as JConfig  # noqa: E402
from avenir_tpu.datagen.price_opt import generate_price_opt as j_price_opt  # noqa: E402
from avenir_tpu.jobs import get_job as j_get_job  # noqa: E402
from avenir_tpu.models import bandits as jb  # noqa: E402
from avenir_tpu_torch.__main__ import main as torch_main  # noqa: E402
from avenir_tpu_torch.core.config import JobConfig  # noqa: E402
from avenir_tpu_torch.datagen.price_opt import generate_price_opt  # noqa: E402
from avenir_tpu_torch.jobs import get_job  # noqa: E402
from avenir_tpu_torch.models import bandits as tb  # noqa: E402
from avenir_tpu_torch.utils import prng  # noqa: E402

SEEDS = [0, 1, 2, 3, 42, -1, 2**31 - 1, 10**6]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _state(g, k, seed):
    """counts, mean rewards and valid mask: ragged groups (2..K arms), about
    a tenth of the valid arms untried, rewards on a continuous scale."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 30, (g, k)).astype(np.float64)
    counts[rng.random((g, k)) < 0.1] = 0
    valid = np.arange(k)[None, :] < rng.integers(2, k + 1, g)[:, None]
    counts[~valid] = 0
    rewards = np.where(counts > 0, rng.random((g, k)) * 100.0, 0.0)
    return counts, rewards, valid


# ---------------------------------------------------------------------------
# prng: gumbel and categorical
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_and_categorical_against_jax(seed):
    """100K rows × 12 arms: the uniform bits under gumbel are equal, its
    values within abs 1e-6; categorical's indices equal, plain and with
    float32 logits in [0, 10)."""
    shape = (100_000, 12)
    key, jkey = prng.prng_key(seed), jax.random.PRNGKey(seed)
    tiny = float(np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(
        prng.uniform(key, shape, tiny, 1.0),
        np.asarray(jax.random.uniform(jkey, shape, minval=tiny, maxval=1.0)))
    got = prng.gumbel(key, shape)
    want = np.asarray(jax.random.gumbel(jkey, shape))
    assert got.dtype == np.float32 and got.shape == shape
    assert np.abs(got - want).max() <= 1e-6
    logits = (np.random.default_rng(seed % 2**32).random(shape) * 10
              ).astype(np.float32)
    for lg in (np.zeros(shape, np.float32), logits):
        np.testing.assert_array_equal(
            prng.categorical(key, lg),
            np.asarray(jax.random.categorical(jkey, lg)))


# ---------------------------------------------------------------------------
# selection functions and the bandit classes
# ---------------------------------------------------------------------------

def _t(*arrays):
    return [torch.as_tensor(np.asarray(a, np.float32 if a.dtype != bool else bool))
            for a in arrays]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_selection_functions_equal_jax(seed):
    counts, rewards, valid = _state(5000, 12, seed)
    jkey, key = jax.random.PRNGKey(seed), prng.prng_key(seed)
    eps = np.random.default_rng(seed).random(5000).astype(np.float32)
    jc, jr, jv = (jax.numpy.asarray(counts, np.float32),
                  jax.numpy.asarray(rewards, np.float32),
                  jax.numpy.asarray(valid))
    c, r, v = _t(counts, rewards, valid)
    pairs = [
        (jb.epsilon_greedy_select(jkey, jc, jr, jv, eps),
         tb.epsilon_greedy_select(key, c, r, v, torch.from_numpy(eps))),
        (jb.ucb1_select(jkey, jc, jr, jv), tb.ucb1_select(key, c, r, v)),
        (jb.softmax_select(jkey, jc, jr, jv, np.float32(0.05)),
         tb.softmax_select(key, c, r, v, 0.05)),
        (jb._random_valid(jkey, jv), tb._random_valid(key, v)),
        (jb._masked_argmax(jb.mean_reward(jc, jr), jv),
         tb._masked_argmax(tb.mean_reward(c, r), v)),
    ]
    for want, got in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # untried arms come first: UCB1 and softmax pick the first untried
    untried = (valid & (counts == 0)).any(axis=1)
    first = np.argmax(valid & (counts == 0), axis=1)
    np.testing.assert_array_equal(pairs[1][1].numpy()[untried], first[untried])


BANDITS = [("greedyRandomLinear", {"epsilon": 0.5, "prob_reduction_constant": 3.0}),
           ("greedyRandomLogLinear", {"epsilon": 0.8}),
           ("auerGreedy", {"auer_constant": 2.0}),
           ("auerDeterministic", {}),
           ("softMax", {"tau": 0.1}),
           ("randomFirstGreedy", {"exploration_count_factor": 2}),
           ("randomFirstGreedy", {"strategy": "pac"})]


@pytest.mark.parametrize("name,kwargs", BANDITS)
def test_bandit_classes_equal_jax(name, kwargs):
    counts, rewards, valid = _state(3000, 9, 7)
    jband = jb.ALGORITHM_REGISTRY[name](**kwargs)
    band = tb.ALGORITHM_REGISTRY[name](device="cpu", **kwargs)
    for rnd in (1, 3, 40, 400):
        want = np.asarray(jband.select(jax.random.PRNGKey(rnd), counts,
                                       rewards, valid, rnd))
        got = band.select(prng.prng_key(rnd), counts, rewards, valid, rnd)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_epsilon_for_round_equals_jax():
    for alg in ("linear", "logLinear", "auer"):
        for rnd in (1, 2, 17, 1000):
            args = (alg, rnd, 3, 0.7, 2.5, 5.0, 12, 0.3)
            assert tb._epsilon_for_round(*args) == jb._epsilon_for_round(*args)
    with pytest.raises(ValueError):
        tb._epsilon_for_round("bogus", 1, 1, 1.0, 1.0, 1.0, 2, 1.0)


def test_group_state_rows_and_update_equal_jax():
    rows = [["g2", "a", "3", "10.5"], ["g1", "x", "0", "0"],
            ["g2", "b", "2", "20.25"], ["g1", "y", "4", "7.0"],
            ["g1", "z", "1", "3.5"]]
    js, ts = jb.GroupState.from_rows(rows), tb.GroupState.from_rows(rows)
    assert ts.groups == js.groups == ["g1", "g2"]
    assert ts.items == js.items
    for f in ("counts", "rewards", "valid"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    for st in (js, ts):
        st.update("g1", "x", 9.0)
        st.update("g2", "b", 1.0)
    assert ts.to_rows() == js.to_rows()
    five = [["g", "i", "2", "30", "15"], ["g", "j", "1", "7", "7"]]
    assert (tb.GroupState.from_rows(five, 2, 4).rewards.tolist()
            == jb.GroupState.from_rows(five, 2, 4).rewards.tolist())


@pytest.mark.parametrize("algorithm,kwargs,finds_best", [
    ("greedyRandomLinear", {"prob_reduction_constant": 20.0}, True),
    ("auerGreedy", {"auer_constant": 5.0}, False),
    ("softMax", {"tau": 0.05}, True),
    ("auerDeterministic", {}, True),
])
def test_bandit_job_rounds_equal_jax(algorithm, kwargs, finds_best):
    """The key chain of BanditJob (split before every select) over 150
    rounds of a closed loop on planted means: equal selections every
    round, and the best arm found where 150 rounds are enough."""
    true_means = np.array([[20.0, 50.0, 35.0], [80.0, 30.0, 55.0],
                           [10.0, 12.0, 60.0]])
    g, k = true_means.shape
    rows = [[f"g{gi}", f"i{ai}", "0", "0"] for gi in range(g) for ai in range(k)]
    jjob = jb.BanditJob(algorithm, seed=1, **kwargs)
    tjob = tb.BanditJob(algorithm, seed=1, device="cpu", **kwargs)
    jst, tst = jb.GroupState.from_rows(rows), tb.GroupState.from_rows(rows)
    rng = np.random.default_rng(4)
    for rnd in range(1, 151):
        sel = tjob.select(tst, rnd)
        assert sel == jjob.select(jst, rnd)
        for grp, item in sel:
            reward = max(rng.normal(true_means[int(grp[1:]), int(item[1:])], 5.0), 0.0)
            jst.update(grp, item, reward)
            tst.update(grp, item, reward)
    np.testing.assert_array_equal(tst.counts, jst.counts)
    if finds_best:
        np.testing.assert_array_equal(np.argmax(tst.counts, axis=1),
                                      np.argmax(true_means, axis=1))
    lines = tjob.select_lines(tst.to_rows(), 200, delim=";")
    assert lines == jjob.select_lines(jst.to_rows(), 200, delim=";")


def test_bandit_job_needs_cuda_or_cpu():
    with pytest.raises(ValueError, match="unknown bandit algorithm"):
        tb.BanditJob("bogus", device="cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.BanditJob("softMax")


# ---------------------------------------------------------------------------
# the four jobs through both CLIs
# ---------------------------------------------------------------------------

JOBS = [
    ("GreedyRandomBandit", ["-Dprob.reduction.algorithm=linear",
                            "-Drandom.selection.prob=0.6"]),
    ("GreedyRandomBandit", ["-Dprob.reduction.algorithm=loglinear",
                            "-Dprob.reduction.constant=4"]),
    ("GreedyRandomBandit", ["-Dprob.reduction.algorithm=auer",
                            "-Dauer.greedy.constant=2"]),
    ("AuerDeterministic", []),
    ("SoftMaxBandit", ["-Dtemp.constant=0.2"]),
    ("RandomFirstGreedyBandit", ["-Dexploration.count.factor=2"]),
    ("RandomFirstGreedyBandit", ["-Dexploration.count.strategy=pac",
                                 "-Dpac.reward.diff=0.4"]),
]


@pytest.mark.parametrize("job,props", JOBS)
def test_bandit_jobs_byte_identical(tmp_path, job, props):
    counts, rewards, valid = _state(400, 8, 11)
    lines = [f"grp{gi:04d},item{ai},{int(counts[gi, ai])},{rewards[gi, ai]:.4f}"
             for gi in range(400) for ai in range(8) if valid[gi, ai]]
    (tmp_path / "in.csv").write_text("\n".join(lines) + "\n")
    common = [*props, "-Dseed=9", "-Dcurrent.round.num=3"]
    outs = {}
    for pkg, main, extra in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", "cpu"])):
        out = tmp_path / pkg
        text = _run(main, [f"org.avenir.reinforce.{job}", *common,
                           str(tmp_path / "in.csv"), str(out), *extra])
        outs[pkg] = ((out / "part-00000").read_bytes(), text)
    assert outs["torch"] == outs["jax"]
    assert "Number=3" in outs["torch"][1]
    assert "Selected=400" in outs["torch"][1]


# ---------------------------------------------------------------------------
# the price-optimisation round loop
# ---------------------------------------------------------------------------

def _price_loop(tmp_path, pkg, job, props, n_rounds):
    """The tutorial's loop, file for file: the bandit job selects a price
    per product; the revenue oracle writes ``inc_<round>``;
    RunningAggregator folds it into the running state, which becomes the
    next round's input.  → (every round's selection and aggregate bytes,
    the last selections, the simulator)."""
    gen, get, conf_cls, run_kw = (
        (j_price_opt, j_get_job, JConfig, {}) if pkg == "jax"
        else (generate_price_opt, get_job, JobConfig, {"device": "cpu"}))
    sim = gen(n_products=8, seed=5)
    work = tmp_path / pkg
    indir = work / "input"
    indir.mkdir(parents=True)
    lines = [f"{pid},{price},0,0,0"
             for pid, p in sim.products.items() for price in p.prices]
    (indir / "agg.txt").write_text("\n".join(lines) + "\n")
    files = []
    selections = []
    for rnd in range(1, n_rounds + 1):
        conf = conf_cls({"current.round.num": str(rnd), "count.ordinal": "2",
                         "reward.ordinal": "4", "seed": str(100 + rnd), **props})
        get(job).run(conf, str(indir), str(work / "select"), **run_kw)
        sel_bytes = (work / "select" / "part-00000").read_bytes()
        selections = [ln.split(",") for ln in sel_bytes.decode().splitlines()]
        inc = [f"{pid},{price},{sim.reward(pid, price):.3f}"
               for pid, price in selections]
        (indir / f"inc_{rnd}.txt").write_text("\n".join(inc) + "\n")
        get("org.chombo.mr.RunningAggregator").run(
            conf_cls({"quantity.attr": "2", "incremental.file.prefix": "inc"}),
            str(indir), str(work / "agg_out"), **run_kw)
        agg_bytes = (work / "agg_out" / "part-00000").read_bytes()
        files.append((sel_bytes, agg_bytes))
        shutil.rmtree(indir)
        indir.mkdir()
        (indir / "agg.txt").write_bytes(agg_bytes)
    return files, selections, sim


@pytest.mark.parametrize("job,props,n_rounds,converge", [
    ("org.avenir.reinforce.GreedyRandomBandit",
     {"prob.reduction.algorithm": "linear", "random.selection.prob": "0.5",
      "prob.reduction.constant": "8.0"}, 60, True),
    ("org.avenir.reinforce.AuerDeterministic", {}, 25, False),
    ("org.avenir.reinforce.SoftMaxBandit", {"temp.constant": "0.05"}, 25, False),
    ("org.avenir.reinforce.RandomFirstGreedyBandit",
     {"exploration.count.factor": "2"}, 25, False),
])
def test_price_optimize_loop_byte_identical(tmp_path, job, props, n_rounds,
                                            converge):
    got, selections, sim = _price_loop(tmp_path, "torch", job, props, n_rounds)
    want, _, _ = _price_loop(tmp_path, "jax", job, props, n_rounds)
    for rnd, (g, w) in enumerate(zip(got, want), 1):
        assert g == w, f"round {rnd} differs"
    # one pull per product per round accumulated in the running state
    per_group = {}
    for line in got[-1][1].decode().splitlines():
        g, _item, cnt, _s, _a = line.split(",")
        per_group[g] = per_group.get(g, 0) + int(cnt)
    assert set(per_group.values()) == {n_rounds}
    if converge:
        n_good = 0
        for pid, price in selections:
            p = sim.products[pid]
            if abs(p.prices.index(int(price)) - int(np.argmax(p.mean_revenue))) <= 1:
                n_good += 1
        assert n_good >= int(0.75 * len(sim.products))


# ---------------------------------------------------------------------------
# Queue 3 faults 3 and 4: near-ties that XLA's float32 ``log`` decides.
# The port keeps the correctly rounded value; these pin where the two
# packages part, so a change on either side shows.
# ---------------------------------------------------------------------------

def test_pin_ucb1_near_tie_parts_at_xlas_float32_log():
    """Counts (3, 4), so t = 7, average rewards (0.8474056, 1.0): XLA's
    float32 log 7 is 1.9459102, the correctly rounded one 1.9459101, and
    the two bonuses tie within that ulp — the JAX package selects arm 0,
    the port arm 1."""
    counts = np.array([[3, 4]], np.float32)
    rewards = np.array([[0.8474056, 1.0]], np.float32)
    valid = np.ones((1, 2), bool)
    assert np.float32(np.log(np.float64(7.0))) == np.float32(1.9459101)
    assert np.float32(jax.numpy.log(jax.numpy.float32(7.0))) == np.float32(1.9459102)
    want = jb.ucb1_select(None, jax.numpy.asarray(counts),
                                jax.numpy.asarray(rewards), jax.numpy.asarray(valid))
    got = tb.ucb1_select(None, *_t(counts, rewards, valid))
    assert np.asarray(want).tolist() == [0]
    assert got.tolist() == [1]


def test_pin_softmax_near_tie_parts_at_gumbel_float32_log():
    """``PRNGKey(11)``, counts (1, 1), rewards (0.06529637, 1.0), τ = 1:
    the uniform bits are equal, the gumbel values differ in the last
    float32 place (the port's log is taken in float64 and rounded once),
    and the draw parts — the JAX package selects arm 1, the port arm 0."""
    counts = np.array([[1, 1]], np.float32)
    rewards = np.array([[0.06529637, 1.0]], np.float32)
    valid = np.ones((1, 2), bool)
    g = prng.gumbel(prng.prng_key(11), (1, 2))
    jg = np.asarray(jax.random.gumbel(jax.random.PRNGKey(11), (1, 2)))
    assert np.abs(g - jg).max() <= 1e-6
    want = jb.softmax_select(jax.random.PRNGKey(11),
                                   jax.numpy.asarray(counts), jax.numpy.asarray(rewards),
                                   jax.numpy.asarray(valid), 1.0)
    got = tb.softmax_select(prng.prng_key(11),
                                 *_t(counts, rewards, valid), 1.0)
    assert np.asarray(want).tolist() == [1]
    assert got.tolist() == [0]

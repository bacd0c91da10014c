"""The online RL learners and the in-process serving loop of the port held
against ``avenir_tpu`` on the CPU: the four learners' action streams and
states, a JAX server's checkpoint resumed in the port
(``convert.learner_state_from_jax``), the ``lead_gen`` closed loop through
``ReinforcementLearnerServer``, the thread fleet, the supervisor's
restarts, the bounded queues, the latency and stats helpers, the process
fleet (forked workers) against the thread fleet, and the ``lead_gen``,
``price_opt`` and ``disease`` generators.  Nothing here binds a socket;
the ``Redis*`` transports are held in ``tests/test_torch_resp.py``."""

import json

import numpy as np
import pytest

from avenir_tpu.datagen import disease as j_disease
from avenir_tpu.datagen import lead_gen as j_lead_gen
from avenir_tpu.datagen import price_opt as j_price_opt
from avenir_tpu.models import online_rl as jorl
from avenir_tpu.pipeline import streaming as jst
from avenir_tpu.utils import metrics as jmetrics
from avenir_tpu_torch import convert
from avenir_tpu_torch.datagen import disease, lead_gen, price_opt
from avenir_tpu_torch.models import online_rl as orl
from avenir_tpu_torch.pipeline import streaming as st
from avenir_tpu_torch.utils import metrics
from avenir_tpu_torch.utils.retry import InjectedFault

CFG = {"min.reward.distr.sample": 12, "min.sample": 12, "max.reward": 90.0,
       "prob.reduction.constant": 20.0, "confidence.limit.reduction.round.interval": 15}
MEANS = {"a": (20.0, 5.0), "b": (50.0, 9.0), "c": (35.0, 4.0)}


def _feed(learner, rounds, seed, start=1):
    """Drive a learner on planted Gaussian rewards → its action stream."""
    rng = np.random.default_rng(seed)
    stream = []
    for r in range(start, start + rounds):
        acts = learner.next_actions(r)
        stream.append(acts)
        for a in acts:
            learner.set_reward(a, max(rng.normal(*MEANS[a]), 0.0))
    return stream


@pytest.mark.parametrize("name", sorted(orl.LEARNER_REGISTRY))
@pytest.mark.parametrize("batch", [1, 3])
def test_learner_action_streams_equal_jax(name, batch):
    assert sorted(orl.LEARNER_REGISTRY) == sorted(jorl.LEARNER_REGISTRY)
    mine = orl.create_learner(name, list(MEANS), CFG, batch_size=batch, seed=7)
    ref = jorl.create_learner(name, list(MEANS), CFG, batch_size=batch, seed=7)
    got, want = _feed(mine, 400, 3), _feed(ref, 400, 3)
    assert got == want
    assert mine.get_state() == ref.get_state()
    flat = [a for acts in got[200:] for a in acts]
    assert max(set(flat), key=flat.count) == "b"


@pytest.mark.parametrize("name", sorted(orl.LEARNER_REGISTRY))
def test_learner_state_round_trip_and_from_jax(name):
    """A JAX learner's checkpoint JSON (through the server's checkpoint())
    restored into a fresh port learner continues with the JAX learner's
    actions; the port's own state round-trips the same way."""
    ref = jorl.create_learner(name, list(MEANS), CFG, seed=5)
    _feed(ref, 150, 8)
    blob = jst.ReinforcementLearnerServer(
        ref, None, None, None).checkpoint()
    mine = orl.create_learner(name, list(MEANS), CFG, seed=5)
    mine.set_state(convert.learner_state_from_jax(blob))
    mine.rng.setstate(ref.rng.getstate())        # the stream past the blob
    assert _feed(mine, 100, 9, start=151) == _feed(ref, 100, 9, start=151)
    again = orl.create_learner(name, list(MEANS), CFG, seed=5)
    again.set_state(json.loads(json.dumps(mine.get_state())))
    assert again.get_state() == mine.get_state()
    assert convert.learner_state_from_jax(ref.get_state()) == mine.get_state()


def test_learner_state_from_jax_refuses_bad_state():
    with pytest.raises(ValueError, match="rewards"):
        convert.learner_state_from_jax('{"stats": {}}')
    with pytest.raises(ValueError, match="unknown fields"):
        convert.learner_state_from_jax({"rewards": {}, "epsilon": 0.1})
    with pytest.raises(ValueError, match="last_round"):
        convert.learner_state_from_jax(
            {"rewards": {}, "cur_confidence": 90.0, "last_round": 2.5})
    with pytest.raises(ValueError):
        orl.create_learner("bogus", ["x"])


def test_server_resumes_a_jax_checkpoint():
    """Serve 120 events in the JAX package, checkpoint, serve the next 80
    in both packages from that checkpoint: the same actions."""
    def run(mod, learner_mod, blob=None, n=120, rounds0=0):
        ev, rw, ac = mod.InProcQueue(), mod.InProcQueue(), mod.InProcQueue()
        learner = learner_mod.create_learner("intervalEstimator", list(MEANS),
                                             CFG, seed=2)
        srv = mod.ReinforcementLearnerServer(
            learner, mod.QueueEventSource(ev), mod.QueueRewardReader(rw),
            mod.QueueActionWriter(ac))
        if blob is not None:
            srv.restore(blob)
        rng = np.random.default_rng(rounds0)
        out = []
        for r in range(rounds0 + 1, rounds0 + n + 1):
            ev.push(f"ev{r},{r}")
            assert srv.process_one()
            msg = ac.pop()
            out.append(msg)
            a = msg.split(",")[1]
            rw.push(f"{a},{max(rng.normal(*MEANS[a]), 0.0)}")
        return srv, out

    jsrv, _ = run(jst, jorl)
    blob = jsrv.checkpoint()
    ported = json.dumps(convert.learner_state_from_jax(blob))
    _, got = run(st, orl, ported, n=80, rounds0=120)
    _, want = run(jst, jorl, blob, n=80, rounds0=120)
    assert got == want


@pytest.mark.parametrize("name", sorted(orl.LEARNER_REGISTRY))
def test_lead_gen_closed_loop_equal_jax(name):
    """The lead_gen simulator through the server: the same selections as
    the JAX package's loop, converging to page3, with the serving stats'
    counters."""
    runs = {}
    for pkg, sim_mod, orl_mod, st_mod in (
            ("torch", lead_gen, orl, st), ("jax", j_lead_gen, jorl, jst)):
        sim = sim_mod.LeadGenSimulator(n_events=1500, seed=3)
        learner = orl_mod.create_learner(name, sim.actions, {
            "min.sample": 20, "min.reward.distr.sample": 20,
            "prob.reduction.constant": 30.0, "max.reward": 100.0}, seed=5)
        srv = st_mod.ReinforcementLearnerServer(learner, events=sim,
                                                rewards=sim, actions=sim)
        assert srv.run() == 1500
        stats = srv.stats()["rl"]
        runs[pkg] = (dict(sim.selections), srv.checkpoint(),
                     {k: v for k, v in stats.items() if not k.endswith("_ms")})
    assert runs["torch"] == runs["jax"]
    selections = runs["torch"][0]
    assert max(selections, key=selections.get) == lead_gen.BEST_ACTION
    assert runs["torch"][2] == {"requests": 1500, "batches": 1500,
                                "bucket.1": 1500, "latency_samples": 1500}


def _fleet(mod, orl_mod, groups, n_rounds, workers=2):
    streams = {g: [] for g in groups}

    def factory(group):
        learner = orl_mod.create_learner(
            "sampsonSampler", ["p1", "p2", "p3"], {"min.sample": 8}, seed=11)
        srv = mod.ReinforcementLearnerServer(
            learner, mod.QueueEventSource(mod.InProcQueue()),
            mod.QueueRewardReader(mod.InProcQueue()),
            mod.QueueActionWriter(mod.InProcQueue()))
        inner = srv.actions

        class Tee:
            def write(self, event_id, acts):
                inner.write(event_id, acts)
                streams[group].append((event_id, list(acts)))
                srv.rewards.queue.push(f"{acts[0]},{10.0 * int(acts[0][1:])}")

        srv.actions = Tee()
        return srv

    fleet = mod.ShardedServingFleet(factory, num_workers=workers, max_pending=8)
    for i in range(1, n_rounds + 1):
        for g in groups:
            fleet.dispatch(g, f"ev{g}{i}", i)
    fleet.close()
    return fleet, streams


def test_thread_fleet_equals_jax():
    """Groups pinned to workers, each learner single-threaded: per-group
    action streams and end states equal the JAX package's fleet's."""
    groups = ["gA", "gB", "gC", "gD", "gE"]
    fleet, streams = _fleet(st, orl, groups, 80, workers=3)
    jfleet, jstreams = _fleet(jst, jorl, groups, 80, workers=3)
    assert fleet.processed == jfleet.processed == 80 * len(groups)
    assert streams == jstreams
    assert fleet.checkpoints() == jfleet.checkpoints()
    with pytest.raises(RuntimeError, match="after close"):
        fleet.dispatch("gA", "late", 81)


def test_thread_fleet_error_surfaces():
    def factory(group):
        raise RuntimeError("factory boom")

    fleet = st.ShardedServingFleet(factory, num_workers=1)
    fleet.dispatch("g", "ev1", 1)
    with pytest.raises(RuntimeError, match="factory boom"):
        fleet.close()


def _supervised(mod, orl_mod, fault_cls, crash_on, total=300, **kw):
    events, rewards, actions = mod.InProcQueue(), mod.InProcQueue(), mod.InProcQueue()
    for i in range(1, total + 1):
        events.push(f"ev{i},{i}")
        rewards.push(f"{'ab'[i % 2]},{float(i % 17)}")
    calls = {"n": 0}
    built = []

    def factory():
        learner = orl_mod.create_learner("randomGreedy", ["a", "b"], {}, seed=9)
        srv = mod.ReinforcementLearnerServer(
            learner, mod.QueueEventSource(events), mod.QueueRewardReader(rewards),
            mod.QueueActionWriter(actions))
        orig = srv.process_one

        def flaky():
            calls["n"] += 1
            if calls["n"] in crash_on:
                raise fault_cls("injected")
            return orig()

        srv.process_one = flaky
        built.append(srv)
        return srv

    sup = mod.ServerSupervisor(factory, **kw)
    return sup, built, actions


@pytest.mark.parametrize("crash_on,kw", [
    ({70}, {"checkpoint_interval": 32, "max_restarts": 2}),
    ({50, 150, 250}, {"checkpoint_interval": 16, "max_restarts": 1,
                      "restart_reset_after": 40}),
])
def test_supervisor_restarts_equal_jax(crash_on, kw):
    from avenir_tpu.utils.retry import InjectedFault as JInjectedFault

    sup, built, actions = _supervised(st, orl, InjectedFault, crash_on, **kw)
    jsup, jbuilt, jactions = _supervised(jst, jorl, JInjectedFault, crash_on, **kw)
    assert sup.run() == jsup.run() == 300
    assert (sup.restarts, sup.events_processed, len(built)) == (
        jsup.restarts, jsup.events_processed, len(jbuilt))
    assert len(built) == len(crash_on) + 1
    assert sup.last_checkpoint == jsup.last_checkpoint
    assert actions.drain() == jactions.drain()


def test_supervisor_crash_loop_raises():
    sup, built, _ = _supervised(st, orl, InjectedFault, set(range(1, 10)),
                                total=20, max_restarts=3)
    with pytest.raises(InjectedFault):
        sup.run()
    assert sup.restarts == 4 and len(built) == 4


def test_inproc_queue_bounds():
    q = st.InProcQueue(depth=3)
    q.push("a")
    q.push_all(["b", "c"])
    with pytest.raises(st.QueueFullError):
        q.push("d")
    with pytest.raises(st.QueueFullError):
        q.push_all(["d"])
    assert len(q) == 3 and q.pop() == "a" and q.drain() == ["b", "c"]
    assert q.pop() is None
    unbounded = st.InProcQueue(depth=0)
    unbounded.push_all(str(i) for i in range(100))
    assert len(unbounded) == 100


def test_server_sheds_on_a_full_action_queue():
    events, rewards = st.InProcQueue(), st.InProcQueue()
    actions = st.InProcQueue(depth=2)
    learner = orl.create_learner("randomGreedy", ["a", "b"], {}, batch_size=2,
                                 seed=1)
    srv = st.ReinforcementLearnerServer(
        learner, st.QueueEventSource(events), st.QueueRewardReader(rewards),
        st.QueueActionWriter(actions), model_name="lead")
    for i in range(1, 4):
        events.push(f"e{i},{i}")
    assert srv.run() == 3
    stats = srv.stats()["lead"]
    assert stats["shed"] == 2 and stats["requests"] == 3 and len(actions) == 2


def _process_fleet(mod, orl_mod, groups, n_rounds, workers, max_pending=8):
    """The thread fleet's groups and rounds through ``mod``'s
    ProcessServingFleet: the same factory (its reward tee runs in the
    forked worker)."""
    unused = {g: [] for g in groups}

    def factory(group):
        learner = orl_mod.create_learner(
            "sampsonSampler", ["p1", "p2", "p3"], {"min.sample": 8}, seed=11)
        srv = mod.ReinforcementLearnerServer(
            learner, mod.QueueEventSource(mod.InProcQueue()),
            mod.QueueRewardReader(mod.InProcQueue()),
            mod.QueueActionWriter(mod.InProcQueue()))
        inner = srv.actions

        class Tee:
            def write(self, event_id, acts):
                inner.write(event_id, acts)
                unused[group].append((event_id, list(acts)))
                srv.rewards.queue.push(f"{acts[0]},{10.0 * int(acts[0][1:])}")

        srv.actions = Tee()
        return srv

    fleet = mod.ProcessServingFleet(factory, num_workers=workers,
                                    max_pending=max_pending)
    for i in range(1, n_rounds + 1):
        for g in groups:
            fleet.dispatch(g, f"ev{g}{i}", i)
    fleet.close()
    return fleet


@pytest.mark.parametrize("workers", [1, 3])
def test_process_fleet_equals_thread_fleet(workers):
    """Forked workers, each group pinned to one by ``hash(group) %
    num_workers``: the forwarded actions and the end states equal the JAX
    package's ProcessServingFleet's on the same groups and rounds, and
    per group the thread fleet's (and the JAX thread fleet's)."""
    groups = ["gA", "gB", "gC", "gD", "gE"]
    tfleet, streams = _fleet(st, orl, groups, 60, workers=workers)
    jtfleet, jstreams = _fleet(jst, jorl, groups, 60, workers=workers)
    pfleet = _process_fleet(st, orl, groups, 60, workers)
    jpfleet = _process_fleet(jst, jorl, groups, 60, workers)

    def per_group(fleet):
        # the workers' forwarded writes interleave as they come; each
        # group's own stream keeps its dispatch order
        out = {g: [] for g in groups}
        for group, event_id, acts in fleet.actions():
            out[group].append((event_id, acts))
        return out

    got = per_group(pfleet)
    assert sum(map(len, got.values())) == 60 * len(groups)
    assert got == per_group(jpfleet) == streams == jstreams
    assert pfleet.checkpoints() == jpfleet.checkpoints()
    assert pfleet.checkpoints() == tfleet.checkpoints() == \
        jtfleet.checkpoints()
    with pytest.raises(RuntimeError, match="after close"):
        pfleet.dispatch("gA", "late", 61)
    pfleet.close()                        # a second close is a no-op


def test_process_fleet_error_surfaces_on_close():
    def factory(group):
        raise RuntimeError("factory boom")

    fleet = st.ProcessServingFleet(factory, num_workers=1)
    fleet.dispatch("g", "ev1", 1)
    with pytest.raises(RuntimeError, match="factory boom"):
        fleet.close()
    with pytest.raises(RuntimeError, match="after close"):
        fleet.dispatch("g", "ev2", 2)


def test_process_fleet_dead_worker_fails_dispatch_and_close():
    """A worker that dies without its shutdown handshake: a dispatch into
    its full queue raises instead of blocking, and ``close()`` raises
    after the idle polls instead of hanging."""
    import os

    def factory(group):
        os._exit(3)

    fleet = st.ProcessServingFleet(factory, num_workers=1, max_pending=1)
    with pytest.raises(RuntimeError, match="serving worker 0 died"):
        for i in range(1, 10):
            fleet.dispatch("g", f"ev{i}", i)
    with pytest.raises(RuntimeError, match="without shutdown handshake"):
        fleet.close()
    assert fleet.checkpoints() == {} and fleet.actions() == []


def test_latency_and_stats_equal_jax():
    samples = np.random.default_rng(1).exponential(0.002, 300)
    for q in (0.0, 50.0, 99.0, 100.0):
        assert metrics.percentile_of(samples, q) == jmetrics.percentile_of(samples, q)
    assert metrics.percentile_of([], 50) == 0.0
    lt, jlt = metrics.LatencyTracker(capacity=128), jmetrics.LatencyTracker(capacity=128)
    for s in samples:
        lt.record(float(s))
        jlt.record(float(s))
    assert lt.snapshot() == jlt.snapshot() and lt.count == 300
    c, jc = metrics.Counters(), jmetrics.Counters()
    for cc in (c, jc):
        cc.increment("Serving.rl", "requests", 5)
        cc.increment("Serving.other", "shed")
    assert metrics.serving_stats(c, {"rl": lt}) == jmetrics.serving_stats(
        jc, {"rl": jlt})
    cm, jcm = (m.ConfusionMatrix(["x", "y"], pos_class="y") for m in (metrics, jmetrics))
    for a, p in ((0, 0), (1, 1), (1, 0), (0, 1), (1, 1)):
        cm.add(a, p)
        jcm.add(a, p)
    cm.add(1, 1, count=3)
    jcm.add(1, 1, count=3)
    pc, jpc = metrics.Counters(), jmetrics.Counters()
    cm.publish(pc)
    jcm.publish(jpc)
    assert pc.as_dict() == jpc.as_dict()


def test_generators_equal_jax():
    rows, jrows = disease.generate_disease(3000, seed=4), j_disease.generate_disease(3000, seed=4)
    np.testing.assert_array_equal(rows, jrows)
    assert disease.DISEASE_SCHEMA_JSON == j_disease.DISEASE_SCHEMA_JSON
    sim, jsim = price_opt.generate_price_opt(100, seed=5), j_price_opt.generate_price_opt(100, seed=5)
    assert sim.initial_rows() == jsim.initial_rows()
    for pid, p in sim.products.items():
        jp = jsim.products[pid]
        assert (p.prices, p.mean_revenue, p.noise_sd, p.optimal_price) == (
            jp.prices, jp.mean_revenue, jp.noise_sd, jp.optimal_price)
        assert [sim.reward(pid, str(x)) for x in p.prices] == [
            jsim.reward(pid, str(x)) for x in p.prices]
    lg, jlg = lead_gen.LeadGenSimulator(50, seed=2), j_lead_gen.LeadGenSimulator(50, seed=2)
    assert lead_gen.CTR_DISTR == j_lead_gen.CTR_DISTR
    while True:
        ev = lg.next_event()
        assert ev == jlg.next_event()
        if ev is None:
            break
        page = lg.actions[ev[1] % 3]
        lg.write(ev[0], [page])
        jlg.write(ev[0], [page])
        assert lg.read_rewards() == jlg.read_rewards()
    assert lg.selections == jlg.selections


def test_pool_utilities_equal_jax():
    items = [("a", 0, 0.0), ("b", 3, 7.0), ("c", 0, 0.0), ("d", 1, 2.0)]
    gi = orl.GroupedItems([orl.Item(*it) for it in items], seed=4)
    jgi = jorl.GroupedItems([jorl.Item(*it) for it in items], seed=4)
    assert ([i.item_id for i in gi.collect_items_not_tried(5)]
            == [i.item_id for i in jgi.collect_items_not_tried(5)] == ["a", "c"])
    assert [gi.select_random().item_id for _ in range(20)] == [
        jgi.select_random().item_id for _ in range(20)]
    assert gi.get_max_reward_item().item_id == "b" and gi.size() == 4
    for rnd in (1, 2, 3, 5, 10):
        ec, jec = orl.ExplorationCounter(5, 3, 11), jorl.ExplorationCounter(5, 3, 11)
        ec.select_next_round(rnd)
        jec.select_next_round(rnd)
        assert ec.selected_indices() == jec.selected_indices()
        assert ec.in_exploration() == jec.in_exploration()

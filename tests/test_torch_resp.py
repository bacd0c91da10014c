"""The port's RESP client and its Redis transports held against
``avenir_tpu`` on the CPU.

Both packages' ``RespClient`` / ``RedisListQueue`` run the same call
sequence against one in-process fake Redis (a threaded socket server on
port 0 speaking the list commands the reference's spout, reader and writer
use); the replies and the request bytes the server records must be equal.
Around that: the reconnect with the db re-selected, the single retry, the
batched drain's fallback, the lead-gen closed loop over the three
``Redis*`` transports (actions equal to the JAX package's for the same
seeds and to the loop over in-process queues), and the scoring plane's
RESP front end, directly and through the serving CLI.  No port number is
handed on that the test does not hold bound: every client connects to the
fake server's own listening socket.
"""

import json
import signal
import socketserver
import threading
import time
from collections import defaultdict, deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from avenir_tpu.core.config import JobConfig as JConf  # noqa: E402
from avenir_tpu.core.csv_io import write_csv  # noqa: E402
from avenir_tpu.datagen.churn import CHURN_SCHEMA_JSON, generate_churn  # noqa: E402
from avenir_tpu.jobs import get_job as jget_job  # noqa: E402
from avenir_tpu.models import online_rl as jorl  # noqa: E402
from avenir_tpu.pipeline import resp as jresp  # noqa: E402
from avenir_tpu.pipeline import streaming as jst  # noqa: E402
from avenir_tpu.serving import BucketedMicrobatcher as JBatcher  # noqa: E402
from avenir_tpu.serving import ModelRegistry as JRegistry  # noqa: E402
from avenir_tpu.serving.frontend import \
    redis_score_frontend as jredis_score_frontend  # noqa: E402
from avenir_tpu_torch.core.config import JobConfig  # noqa: E402
from avenir_tpu_torch.models import online_rl as orl  # noqa: E402
from avenir_tpu_torch.pipeline import resp  # noqa: E402
from avenir_tpu_torch.pipeline import streaming as st  # noqa: E402
from avenir_tpu_torch.serving import (BucketedMicrobatcher,  # noqa: E402
                                      ModelRegistry, redis_score_frontend)

PACKAGES = {"torch": (resp, st, orl), "jax": (jresp, jst, jorl)}


class _FakeRedisHandler(socketserver.BaseRequestHandler):
    """The list commands of Redis over RESP2.  ``server.drops`` > 0 closes
    the connection WITHOUT executing the parsed command (a server restart
    or an idle reap), so a client retry is exactly-once; every parsed
    command's raw bytes go to ``server.wire``."""

    def handle(self):
        buf = b""
        while True:
            try:
                chunk = self.request.recv(65536)
            except OSError:
                return
            if not chunk:
                return
            buf += chunk
            while True:
                cmd, rest = self._parse(buf)
                if cmd is None:
                    break
                raw, buf = buf[:len(buf) - len(rest)], rest
                with self.server.lock:
                    drop = self.server.drops > 0
                    if drop:
                        self.server.drops -= 1
                    else:
                        self.server.wire.append(raw)
                if drop:
                    return
                self.request.sendall(self._execute(cmd))

    @staticmethod
    def _parse(buf):
        # a RESP array of bulk strings: (args or None, the rest of buf)
        if not buf.startswith(b"*") or b"\r\n" not in buf:
            return None, buf
        head, rest = buf.split(b"\r\n", 1)
        args = []
        for _ in range(int(head[1:])):
            if not rest.startswith(b"$") or b"\r\n" not in rest:
                return None, buf
            lh, rest2 = rest.split(b"\r\n", 1)
            ln = int(lh[1:])
            if len(rest2) < ln + 2:
                return None, buf
            args.append(rest2[:ln].decode())
            rest = rest2[ln + 2:]
        return args, rest

    def _execute(self, args):
        lists = self.server.lists
        with self.server.lock:
            if self.server.refuse:
                return b"-ERR going away\r\n"
            cmd = args[0].upper()
            if cmd == "PING":
                return b"+PONG\r\n"
            if cmd == "SELECT":
                return b"+OK\r\n"
            if cmd == "LPUSH":
                lists[args[1]].appendleft(args[2])
                return b":%d\r\n" % len(lists[args[1]])
            if cmd == "RPOP" and len(args) == 3:
                if not self.server.rpop_count_ok:
                    return b"-ERR wrong number of arguments for 'rpop' command\r\n"
                q = lists.get(args[1])
                if not q:
                    return b"*-1\r\n"
                vals = [q.pop() for _ in range(min(int(args[2]), len(q)))]
                if not q:
                    del lists[args[1]]
                body = b"".join(b"$%d\r\n%s\r\n" % (len(v.encode()), v.encode())
                                for v in vals)
                return b"*%d\r\n%s" % (len(vals), body)
            if cmd == "RPOP":
                q = lists.get(args[1])
                if not q:
                    return b"$-1\r\n"
                v = q.pop().encode()
                if not q:                   # redis removes empty lists
                    del lists[args[1]]
                return b"$%d\r\n%s\r\n" % (len(v), v)
            if cmd == "LLEN":
                return b":%d\r\n" % len(lists.get(args[1], ()))
            if cmd == "LINDEX":
                q = lists.get(args[1])
                i = int(args[2])
                if q is None or not (-len(q) <= i < len(q)):
                    return b"$-1\r\n"
                v = list(q)[i].encode()
                return b"$%d\r\n%s\r\n" % (len(v), v)
            if cmd == "DEL":
                existed = args[1] in lists
                lists.pop(args[1], None)
                return b":%d\r\n" % int(existed)
            return b"-ERR unknown command '%s'\r\n" % cmd.encode()


def _reset(srv):
    with srv.lock:
        srv.lists.clear()
        srv.wire.clear()
        srv.drops = 0
        srv.rpop_count_ok = True
        srv.refuse = False


@pytest.fixture()
def redis_server():
    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), _FakeRedisHandler)
    srv.daemon_threads = True
    srv.lists = defaultdict(deque)
    srv.wire = []
    srv.lock = threading.Lock()
    _reset(srv)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()


def _both(srv, run):
    """``run(package modules)`` once per package against a fresh server
    state; {package: (result, the request bytes the server recorded)}."""
    out = {}
    for name, mods in PACKAGES.items():
        _reset(srv)
        result = run(*mods)
        with srv.lock:
            out[name] = (result, list(srv.wire))
    return out


# ---------------------------------------------------------------------------
# the client and the queue, held against the JAX package's
# ---------------------------------------------------------------------------

def test_client_replies_and_wire_equal_jax(redis_server):
    host, port = redis_server.server_address

    def run(resp_mod, _st, _orl):
        c = resp_mod.RespClient(host, port, db=2)
        got = [c.ping(), c.lpush("q", "a"), c.lpush("q", "b,c"),
               c.lpush("q", "é ünïcode"), c.llen("q"), c.lindex("q", 0),
               c.lindex("q", -1), c.lindex("q", 9), c.rpop("q"),
               c.rpop_count("q", 5), c.rpop("q"), c.rpop_count("q", 5),
               c.lpush("k", "x"), c.delete("k"), c.delete("k"),
               c.command("LPUSH", "n", 7), c.command("LPUSH", "n", 2.5),
               c.command("LPUSH", "n", b"raw")]
        with pytest.raises(resp_mod.RespError, match="unknown command"):
            c.command("BOGUS", "x")
        got.append(c.reconnects)
        c.close()
        return got

    runs = _both(redis_server, run)
    assert runs["torch"] == runs["jax"]
    got, wire = runs["torch"]
    assert got[:12] == [True, 1, 2, 3, 3, "é ünïcode", "a", None, "a",
                        ["b,c", "é ünïcode"], None, None]
    assert wire[0] == b"*2\r\n$6\r\nSELECT\r\n$1\r\n2\r\n"
    assert len(wire) == 20


def test_list_queue_equal_jax(redis_server):
    host, port = redis_server.server_address

    def run(resp_mod, _st, _orl):
        q = resp_mod.RedisListQueue("events", host=host, port=port)
        q.push("e1,1")
        q.push("e2,2")
        got = [len(q), q.pop(), q.drain(), q.pop()]
        for i in range(300):                 # three batched pops of 128
            q.push(f"m{i}")
        got.append(q.drain())
        got.append(q.drain())
        q.client.close()
        return got

    runs = _both(redis_server, run)
    assert runs["torch"] == runs["jax"]
    got = runs["torch"][0]
    assert got[:4] == [2, "e1,1", ["e2,2"], None]
    assert got[4] == [f"m{i}" for i in range(300)] and got[5] == []


def test_drain_falls_back_to_single_pops_like_jax(redis_server):
    """A server without ``RPOP key count`` (redis < 6.2): the first
    RespError downgrades the queue to one RPOP a message, for good."""
    host, port = redis_server.server_address

    def run(resp_mod, _st, _orl):
        redis_server.rpop_count_ok = False
        q = resp_mod.RedisListQueue("events", host=host, port=port)
        for m in "abc":
            q.push(m)
        first = q.drain()
        batched = q._batch_pop
        q.push("d")
        got = [first, batched, q.drain()]
        q.client.close()
        return got

    runs = _both(redis_server, run)
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][0] == [["a", "b", "c"], False, ["d"]]
    # the fallback's wire: one refused RPOP count, then single pops
    rpops = [w for w in runs["torch"][1] if b"RPOP" in w]
    assert rpops[0].startswith(b"*3\r\n") and \
        all(w.startswith(b"*2\r\n") for w in rpops[1:])


# ---------------------------------------------------------------------------
# transport faults: one reconnect, one resend, the db re-selected
# ---------------------------------------------------------------------------

def test_reconnect_reselects_db_and_resends_once(redis_server):
    host, port = redis_server.server_address

    def run(resp_mod, _st, _orl):
        c = resp_mod.RespClient(host, port, db=3)
        first = c.lpush("q", "a")
        redis_server.drops = 1      # the next command's connection drops
        second = c.lpush("q", "b")
        got = [first, second, c.reconnects, c.rpop("q"), c.rpop("q")]
        c.close()
        return got

    runs = _both(redis_server, run)
    assert runs["torch"] == runs["jax"]
    got, wire = runs["torch"]
    assert got == [1, 2, 1, "a", "b"]
    selects = [w for w in wire if b"SELECT" in w]
    assert selects == [b"*2\r\n$6\r\nSELECT\r\n$1\r\n3\r\n"] * 2
    # the dropped LPUSH never executed: it is on the wire once, after the
    # second SELECT
    pushes_b = [i for i, w in enumerate(wire) if w.endswith(b"$1\r\nb\r\n")]
    assert len(pushes_b) == 1 and wire.index(selects[1]) < pushes_b[0]


def test_gives_up_after_one_retry(redis_server):
    """Two transport faults on one command raise: the retry budget is one
    reconnect a ``command()``.  The fake drops twice (the command, then
    its resend on the new connection); its listener stays up."""
    host, port = redis_server.server_address
    for resp_mod, _st, _orl in PACKAGES.values():
        _reset(redis_server)
        c = resp_mod.RespClient(host, port)
        assert c.ping()
        redis_server.drops = 2
        with pytest.raises(ConnectionError):
            c.ping()
        assert c.reconnects == 1
        assert redis_server.drops == 0
        c.close()
        # with retry=False a single fault surfaces at once
        c = resp_mod.RespClient(host, port)
        redis_server.drops = 1
        with pytest.raises(ConnectionError):
            c.command("LPUSH", "q", "x", retry=False)
        assert c.reconnects == 0
        c.close()
        assert redis_server.lists.get("q") is None


def test_queue_drain_survives_a_dropped_connection(redis_server):
    host, port = redis_server.server_address

    def run(resp_mod, _st, _orl):
        q = resp_mod.RedisListQueue("events", host=host, port=port)
        for i in range(5):
            q.push(f"m{i}")
        redis_server.drops = 1
        got = [q.drain(), q.client.reconnects]
        q.client.close()
        return got

    runs = _both(redis_server, run)
    assert runs["torch"][0] == runs["jax"][0] == \
        [[f"m{i}" for i in range(5)], 1]


# ---------------------------------------------------------------------------
# the lead-gen closed loop over the three Redis* transports
# ---------------------------------------------------------------------------

CTR = {"page1": (30, 12), "page2": (60, 30), "page3": (80, 10)}


def _lead_gen_loop(resp_mod, st_mod, orl_mod, name, transport, address,
                   total=300):
    """The reference topology with both network hops (or in-process
    queues): events and rewards pushed, actions popped; returns the
    actions, the learner's checkpoint and the serving counters."""
    rng = np.random.default_rng(7)
    learner = orl_mod.create_learner(name, list(CTR), {
        "min.reward.distr.sample": 15, "min.sample": 15,
        "prob.reduction.constant": 30.0, "max.reward": 100.0}, seed=3)
    if transport == "redis":
        host, port = address
        server = st_mod.ReinforcementLearnerServer(
            learner, st_mod.RedisEventSource(host, port, queue="eventQueue"),
            st_mod.RedisRewardReader(host, port, queue="rewardQueue"),
            st_mod.RedisActionWriter(host, port, queue="actionQueue"))
        sim = {q: resp_mod.RedisListQueue(q, host=host, port=port)
               for q in ("eventQueue", "actionQueue", "rewardQueue")}
    else:
        sim = {q: st_mod.InProcQueue()
               for q in ("eventQueue", "actionQueue", "rewardQueue")}
        server = st_mod.ReinforcementLearnerServer(
            learner, st_mod.QueueEventSource(sim["eventQueue"]),
            st_mod.QueueRewardReader(sim["rewardQueue"]),
            st_mod.QueueActionWriter(sim["actionQueue"]))
    actions = []
    for round_num in range(1, total + 1):
        sim["eventQueue"].push(f"ev{round_num},{round_num}")
        assert server.process_one()
        msg = sim["actionQueue"].pop()
        actions.append(msg)
        page = msg.split(",")[1]
        mu, sd = CTR[page]
        sim["rewardQueue"].push(f"{page},{max(rng.normal(mu, sd), 0.0)}")
    assert server.processed == total
    stats = {k: v for k, v in server.stats()["rl"].items()
             if not k.endswith("_ms")}
    return actions, server.checkpoint(), stats


@pytest.mark.parametrize("name", sorted(orl.LEARNER_REGISTRY))
def test_lead_gen_loop_over_redis_equal_jax(redis_server, name):
    address = redis_server.server_address
    runs = _both(redis_server, lambda r, s, o: _lead_gen_loop(
        r, s, o, name, "redis", address))
    assert runs["torch"][0] == runs["jax"][0]
    assert runs["torch"][1] == runs["jax"][1]        # the same wire
    inproc = _lead_gen_loop(resp, st, orl, name, "inproc", None)
    assert runs["torch"][0] == inproc
    if name == "intervalEstimator":
        late = [a.split(",")[1] for a in inproc[0][150:]]
        assert max(set(late), key=late.count) == "page3"


# ---------------------------------------------------------------------------
# the scoring plane's RESP front end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nb_ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_resp")
    j = lambda *p: str(root.joinpath(*p))  # noqa: E731
    rows = generate_churn(400, seed=7)
    write_csv(j("train.csv"), rows[:320])
    write_csv(j("test.csv"), rows[320:])
    root.joinpath("churn.json").write_text(json.dumps(CHURN_SCHEMA_JSON))
    props = {"feature.schema.file.path": j("churn.json"),
             "bayesian.model.file.path": j("nb_model"),
             "serve.models": "naiveBayes", "serve.bucket.sizes": "1,4",
             "serve.flush.deadline.ms": "5"}
    jget_job("BayesianDistribution").run(
        JConf({"feature.schema.file.path": j("churn.json")}), j("train.csv"),
        j("nb_model"))
    with open(j("test.csv")) as fh:
        lines = [ln.rstrip("\n") for ln in fh][:12]
    return {"j": j, "props": props, "lines": lines}


def _score_over_redis(srv, frontend_fn, batcher, lines):
    host, port = srv.server_address
    fe = frontend_fn(batcher, host=host, port=port,
                     request_queue="req", response_queue="resp")
    client = resp.RedisListQueue("req", host=host, port=port)
    for i, ln in enumerate(lines):
        client.push(f"r{i},naiveBayes,{ln}")
    client.push("r-bad,nosuch,a,b")
    client.push("malformed")
    assert fe.run(max_messages=len(lines) + 2, idle_limit_s=10.0) == \
        len(lines) + 2
    out = resp.RedisListQueue("resp", host=host, port=port).drain()
    client.client.close()
    fe.requests.client.close()
    fe.responses.client.close()
    return out


def test_redis_score_frontend_equal_jax(redis_server, nb_ws):
    lines = nb_ws["lines"]
    conf = JobConfig(dict(nb_ws["props"]))
    batcher = BucketedMicrobatcher.from_conf(
        ModelRegistry.from_conf(conf, device="cpu"), conf)
    try:
        got = _score_over_redis(redis_server, redis_score_frontend, batcher,
                                lines)
        want_port = [f"r{i},{batcher.submit('naiveBayes', ln)}"
                     for i, ln in enumerate(lines)]
    finally:
        batcher.close()
    _reset(redis_server)
    jconf = JConf(dict(nb_ws["props"]))
    jbatcher = JBatcher.from_conf(JRegistry.from_conf(jconf), jconf)
    try:
        want = _score_over_redis(redis_server, jredis_score_frontend,
                                 jbatcher, lines)
    finally:
        jbatcher.close()
    assert got == want
    # typed failures are answered while the drained batch is submitted,
    # the scored rows after it
    assert got[0].startswith("r-bad,ERR,UNKNOWN_MODEL,")
    assert got[1].startswith("malformed,ERR,BAD_REQUEST,")
    assert got[2:] == want_port


def test_serving_cli_polls_the_request_queue(redis_server, nb_ws, tmp_path,
                                             monkeypatch, capsys):
    """``serve.request.queue`` in the serving CLI: a daemon thread runs the
    RESP front end once HTTP is bound, and the CLI says so; the answers
    equal the one-process batcher's.  The CLI's SIGTERM handler is taken
    from ``signal.signal`` and called, so no signal is sent; the front
    end's daemon thread (it polls for the process's life) is ended by the
    fake refusing every command."""
    from avenir_tpu_torch.pipeline.resp import RespError
    from avenir_tpu_torch.serving.__main__ import main

    host, port = redis_server.server_address
    conf = tmp_path / "serve.properties"
    conf.write_text("".join(f"{k}={v}\n" for k, v in nb_ws["props"].items()))
    handlers = {}
    monkeypatch.setattr(signal, "signal",
                        lambda sig, fn: handlers.__setitem__(sig, fn))
    rc = {}
    cli = threading.Thread(target=lambda: rc.setdefault("rc", main([
        "--conf", str(conf), "--http-port", "0", "--device", "cpu",
        "-D", "serve.request.queue=scoreReq", "-D", f"serve.redis.host={host}",
        "-D", f"serve.redis.port={port}",
        "-D", "serve.response.queue=scoreResp"])), daemon=True)
    cli.start()
    lines = nb_ws["lines"][:5]
    client = resp.RedisListQueue("scoreReq", host=host, port=port)
    for i, ln in enumerate(lines):
        client.push(f"q{i},naiveBayes,{ln}")
    out = resp.RedisListQueue("scoreResp", host=host, port=port)
    got, deadline = [], time.monotonic() + 60.0
    while len(got) < len(lines) and time.monotonic() < deadline:
        got += out.drain()
        time.sleep(0.02)
    deadline = time.monotonic() + 30.0
    while signal.SIGTERM not in handlers and time.monotonic() < deadline:
        time.sleep(0.02)
    handlers[signal.SIGTERM](signal.SIGTERM, None)
    cli.join(timeout=30.0)
    assert not cli.is_alive() and rc == {"rc": 0}
    died = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda a: died.append((a.thread.name, a.exc_type)))
    redis_server.refuse = True
    poller = [t for t in threading.enumerate() if t.name == "serve-resp"]
    assert len(poller) == 1
    poller[0].join(timeout=30.0)
    assert not poller[0].is_alive() and died == [("serve-resp", RespError)]
    conf_obj = JobConfig(dict(nb_ws["props"]))
    batcher = BucketedMicrobatcher.from_conf(
        ModelRegistry.from_conf(conf_obj, device="cpu"), conf_obj)
    try:
        want = [f"q{i},{batcher.submit('naiveBayes', ln)}"
                for i, ln in enumerate(lines)]
    finally:
        batcher.close()
    assert sorted(got) == sorted(want)
    printed = capsys.readouterr().out
    assert "RESP transport polling 'scoreReq'" in printed
    assert printed.index("serving ['naiveBayes'] on http://") < \
        printed.index("RESP transport polling")

"""The port's serving plane held against ``avenir_tpu`` on the CPU.

The artifacts are trained once by the JAX package's own jobs; both
packages' registries load the same files.  For every family the port's
``ScoringPlane`` replay is byte for byte the JAX package's replay, the
port's batch predictor job and the JAX package's batch job on the same
rows.  Around that: padding, warmup and the shape keys, typed shed,
timeout and bad-request errors, both front ends (the HTTP handlers driven
on in-memory streams, never a socket), the pipeline ``serve`` stage, the
RL loop's shared stats schema, and what is refused before any output.
Every wait has a timeout.
"""

import io
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from avenir_tpu.core.config import JobConfig as JConf  # noqa: E402
from avenir_tpu.core.csv_io import write_csv  # noqa: E402
from avenir_tpu.datagen.churn import CHURN_SCHEMA_JSON, generate_churn  # noqa: E402
from avenir_tpu.datagen.retarget import (RETARGET_SCHEMA_JSON,  # noqa: E402
                                         generate_retarget)
from avenir_tpu.jobs import get_job as jget_job  # noqa: E402
from avenir_tpu_torch.core.config import ConfigError, JobConfig  # noqa: E402
from avenir_tpu_torch.jobs import get_job  # noqa: E402
from avenir_tpu_torch.jobs.base import read_lines  # noqa: E402
from avenir_tpu_torch.serving import (BucketedMicrobatcher,  # noqa: E402
                                      ModelRegistry, QueueScoreFrontend,
                                      RequestError, RequestTimeout,
                                      ScoreHTTPServer, ShedError,
                                      UnknownModelError)

WAIT_S = 60.0


# ---------------------------------------------------------------------------
# artifacts, trained once by the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serving")
    j = lambda *p: str(root.joinpath(*p))  # noqa: E731
    rows = generate_churn(600, seed=7)
    write_csv(j("train.csv"), rows[:480])
    write_csv(j("test.csv"), rows[480:])
    root.joinpath("churn.json").write_text(json.dumps(CHURN_SCHEMA_JSON))
    churn = {"feature.schema.file.path": j("churn.json")}
    jget_job("BayesianDistribution").run(JConf(dict(churn)), j("train.csv"),
                                         j("nb_model"))
    jget_job("LogisticRegressionJob").run(
        JConf({**churn, "coeff.file.path": j("coeff.txt"),
               "iteration.limit": "8"}), j("train.csv"), j("lr_out"))
    write_csv(j("rdata.csv"), generate_retarget(1000, seed=3))
    root.joinpath("retarget.json").write_text(
        json.dumps(RETARGET_SCHEMA_JSON))
    retarget = {"feature.schema.file.path": j("retarget.json")}
    jget_job("DecisionTreeBuilder").run(JConf(dict(retarget)), j("rdata.csv"),
                                        j("tree_model"))
    tagged = root.joinpath("tagged")
    tagged.mkdir()
    tagged.joinpath("part-00000").write_text(
        "c1,x:A,y:B,x:A\nc2,y:B,y:B\nc3,x:A,y:B,x:A,x:A\n")
    jget_job("HiddenMarkovModelBuilder").run(JConf({}), str(tagged),
                                             j("hmm_model"))
    seq_lines = ["u1,1,x,y,x", "u2,2,y", "u3,3,x,y,x,x,y", "u4,4,y,x",
                 "u5,5,x", "u6,6,y,y,x,y"]
    os.makedirs(j("obs"))
    with open(j("obs", "part-00000"), "w") as fh:
        fh.write("\n".join(seq_lines) + "\n")
    return {"j": j, "churn": churn, "retarget": retarget,
            "seq_lines": seq_lines}


def _batcher(props, **kwargs):
    conf = JobConfig(dict(props))
    registry = ModelRegistry.from_conf(conf, device="cpu")
    return BucketedMicrobatcher.from_conf(registry, conf, **kwargs), registry


def _serve_all(batcher, model, lines, burst=5):
    """Submit in bursts, so requests coalesce into buckets; the responses
    in request order."""
    out = []
    for i in range(0, len(lines), burst):
        pend = [batcher.submit_nowait(model, ln) for ln in lines[i:i + burst]]
        out.extend(p.wait(WAIT_S) for p in pend)
    return out


def _replays(ws, props, model, input_path, tag):
    """(port replay, JAX replay) part-file lines of ``ScoringPlane`` over
    ``input_path`` with ``props``."""
    j = ws["j"]
    # a replay queues every row at once: the request timeout is a latency
    # limit for online clients, and a loaded test machine must not trip it
    full = {**props, "serve.models": model,
            "serve.request.timeout.ms": "60000"}
    get_job("ScoringPlane").run(JobConfig(dict(full)), input_path,
                                j(f"{tag}_port"), device="cpu")
    jget_job("ScoringPlane").run(JConf(dict(full)), input_path,
                                 j(f"{tag}_jax"))
    return read_lines(j(f"{tag}_port")), read_lines(j(f"{tag}_jax"))


# ---------------------------------------------------------------------------
# replay parity, one test per family
# ---------------------------------------------------------------------------

def test_naive_bayes_parity(ws):
    j, churn = ws["j"], ws["churn"]
    props = {**churn, "bayesian.model.file.path": j("nb_model")}
    get_job("BayesianPredictor").run(JobConfig(dict(props)), j("test.csv"),
                                     j("nb_pred"), device="cpu")
    jget_job("BayesianPredictor").run(JConf(dict(props)), j("test.csv"),
                                      j("nb_pred_jax"))
    batch = read_lines(j("nb_pred"))
    assert batch == read_lines(j("nb_pred_jax"))
    port, jax_ = _replays(ws, {**props, "serve.bucket.sizes": "1,4,16"},
                          "naiveBayes", j("test.csv"), "nb_replay")
    assert port == jax_ == batch
    b, _ = _batcher({**props, "serve.models": "naiveBayes",
                     "serve.bucket.sizes": "1,4,16"})
    try:
        assert _serve_all(b, "naiveBayes", read_lines(j("test.csv"))) == batch
        assert b.counters.get("Serving.naiveBayes", "recompiles") == 0
    finally:
        b.close()


def test_knn_parity_with_kernel_weighting(ws):
    j, churn = ws["j"], ws["churn"]
    props = {**churn, "training.data.path": j("train.csv"),
             "top.match.count": "7", "kernel.function": "gaussian",
             "kernel.param": "0.25", "inverse.distance.weighted": "true"}
    get_job("NearestNeighbor").run(JobConfig(dict(props)), j("test.csv"),
                                   j("knn_pred"), device="cpu")
    jget_job("NearestNeighbor").run(JConf(dict(props)), j("test.csv"),
                                    j("knn_pred_jax"))
    batch = read_lines(j("knn_pred"))
    assert batch == read_lines(j("knn_pred_jax"))
    port, jax_ = _replays(ws, {**props, "serve.bucket.sizes": "1,4"}, "knn",
                          j("test.csv"), "knn_replay")
    assert port == jax_ == batch
    b, _ = _batcher({**props, "serve.models": "knn",
                     "serve.bucket.sizes": "1,4"})
    try:
        assert _serve_all(b, "knn", read_lines(j("test.csv"))[:60],
                          burst=4) == batch[:60]
    finally:
        b.close()


def test_knn_row_does_not_depend_on_its_bucket(ws):
    """A row scored alone and in a full bucket of other rows gives the
    same bytes: every route orders by (exact d², reference index)."""
    j, churn = ws["j"], ws["churn"]
    props = {**churn, "training.data.path": j("train.csv"),
             "top.match.count": "5", "serve.models": "knn",
             "serve.bucket.sizes": "1,16", "serve.flush.deadline.ms": "200"}
    lines = read_lines(j("test.csv"))[:16]
    b, registry = _batcher(props)
    try:
        alone = [registry.get("knn").score_lines([ln], 1)[0] for ln in lines]
        assert registry.get("knn").score_lines(lines, 16) == alone
        pend = [b.submit_nowait("knn", ln) for ln in lines]
        assert [p.wait(WAIT_S) for p in pend] == alone
        assert b.counters.get("Serving.knn", "bucket.16") >= 1
    finally:
        b.close()


def test_tree_parity(ws):
    j, retarget = ws["j"], ws["retarget"]
    props = {**retarget, "tree.model.file.path": j("tree_model")}
    get_job("DecisionTreeBuilder").run(JobConfig(dict(props)), j("rdata.csv"),
                                       j("tree_pred"), device="cpu")
    jget_job("DecisionTreeBuilder").run(JConf(dict(props)), j("rdata.csv"),
                                        j("tree_pred_jax"))
    batch = read_lines(j("tree_pred"))
    assert batch == read_lines(j("tree_pred_jax"))
    port, jax_ = _replays(ws, {**props, "serve.bucket.sizes": "1,8"}, "tree",
                          j("rdata.csv"), "tree_replay")
    assert port == jax_ == batch


def test_tree_hot_swap_same_bucket_zero_recompiles(ws):
    """A hot swap onto a retrained tree of another depth inside the same
    shape buckets counts no recompile, even without the swap barrier's
    warmup, and the post-swap responses are the new model's."""
    from avenir_tpu_torch.serving.registry import TreeServable

    j, retarget = ws["j"], ws["retarget"]
    write_csv(j("rdata2.csv"), generate_retarget(900, seed=17))
    jget_job("DecisionTreeBuilder").run(
        JConf({**retarget, "max.depth": "3"}), j("rdata2.csv"),
        j("tree_model_v2"))
    b, registry = _batcher({**retarget,
                            "tree.model.file.path": j("tree_model"),
                            "serve.models": "tree",
                            "serve.bucket.sizes": "1,8"})
    try:
        lines = read_lines(j("rdata.csv"))[:16]
        _serve_all(b, "tree", lines, burst=4)
        entry_v2 = TreeServable.from_conf(JobConfig(
            {**retarget, "tree.model.file.path": j("tree_model_v2")}),
            device="cpu")
        assert entry_v2._shape_sig == registry.get("tree")._shape_sig
        assert b.swap("tree", entry_v2, warm=False) == 2
        served = _serve_all(b, "tree", lines, burst=4)
        assert b.counters.get("Serving.tree", "recompiles") == 0
        assert b.counters.get("Serving.tree", "swaps") == 1
        jget_job("DecisionTreeBuilder").run(
            JConf({**retarget, "tree.model.file.path": j("tree_model_v2")}),
            j("rdata.csv"), j("tree_pred_v2"))
        assert served == read_lines(j("tree_pred_v2"))[:16]
    finally:
        b.close()


def test_viterbi_parity_state_sequences(ws):
    j = ws["j"]
    props = {"hmm.model.file.path": j("hmm_model"), "skip.field.count": "2"}
    get_job("ViterbiStatePredictor").run(JobConfig(dict(props)), j("obs"),
                                         j("vit_pred"), device="cpu")
    jget_job("ViterbiStatePredictor").run(JConf(dict(props)), j("obs"),
                                          j("vit_pred_jax"))
    batch = read_lines(j("vit_pred"))
    assert batch == read_lines(j("vit_pred_jax"))
    # serving pads every sequence to serve.sequence.pad.len, the batch job
    # to the batch maximum: equal paths show pad steps are identities
    port, jax_ = _replays(ws, {**props, "serve.bucket.sizes": "1,4",
                               "serve.sequence.pad.len": "12"},
                          "viterbi", j("obs"), "vit_replay")
    assert port == jax_ == batch


def test_logistic_parity(ws):
    """The LR family has no batch predictor job: the oracle is the JAX
    package's ``predict_batch`` line, as its own serving test builds it."""
    from avenir_tpu.jobs.base import Job as JJob
    from avenir_tpu.models import logistic as jlr

    j, churn = ws["j"], ws["churn"]
    props = {**churn, "coeff.file.path": j("coeff.txt")}
    _enc, ds, _ = JJob.encode_input(JConf(dict(props)), j("test.csv"),
                                    with_labels=False, need_rows=False)
    model = jlr.LogisticRegressionModel.from_history_lines(
        read_lines(j("coeff.txt")))
    probs, pred = jlr.predict_batch(model, jlr.design_matrix(ds))
    oracle = [f"{ln},{int(pred[i])},{probs[i]:.6f}"
              for i, ln in enumerate(read_lines(j("test.csv")))]
    port, jax_ = _replays(ws, {**props, "serve.bucket.sizes": "1,4,16"},
                          "logistic", j("test.csv"), "lr_replay")
    assert port == jax_ == oracle


# ---------------------------------------------------------------------------
# bucketing, padding, warmup and shape keys
# ---------------------------------------------------------------------------

def test_pad_rows_never_leak_and_histogram(ws):
    """Three requests in one bucket-8 batch score as three lone bucket-1
    requests, and the histogram shows one bucket-8 batch."""
    j, churn = ws["j"], ws["churn"]
    lines = read_lines(j("test.csv"))[:3]
    props = {**churn, "bayesian.model.file.path": j("nb_model"),
             "serve.models": "naiveBayes"}
    b1, _ = _batcher({**props, "serve.bucket.sizes": "1"})
    try:
        singles = [b1.submit("naiveBayes", ln, timeout_s=WAIT_S)
                   for ln in lines]
    finally:
        b1.close()
    b8, _ = _batcher({**props, "serve.bucket.sizes": "8",
                      "serve.flush.deadline.ms": "150"})
    try:
        pend = [b8.submit_nowait("naiveBayes", ln) for ln in lines]
        assert [p.wait(WAIT_S) for p in pend] == singles
        assert b8.counters.get("Serving.naiveBayes", "bucket.8") == 1
        assert b8.counters.get("Serving.naiveBayes", "batches") == 1
    finally:
        b8.close()


def test_pad_ballast_equals_the_jax_package(ws):
    """``core.encoding.pad_ballast`` pads as the JAX package's does: codes
    with the fill, floats with 0, labels with -1."""
    from avenir_tpu.core.encoding import EncodedDataset as JDs
    from avenir_tpu.core.encoding import pad_ballast as jpad
    from avenir_tpu_torch.core.encoding import EncodedDataset, pad_ballast

    rng = np.random.default_rng(3)
    fields = dict(codes=rng.integers(0, 5, (5, 3)).astype(np.int32),
                  cont=rng.random((5, 2)).astype(np.float32),
                  labels=rng.integers(0, 2, 5).astype(np.int32),
                  n_bins=np.array([5, 5, 5], np.int32),
                  class_values=["a", "b"], binned_ordinals=[0, 1, 2],
                  cont_ordinals=[3, 4])
    for fill in (-1, 0):
        got = pad_ballast(EncodedDataset(**fields), 8, fill=fill)
        want = jpad(JDs(**fields), 8, fill=fill)
        for name in ("codes", "cont", "labels"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
    with pytest.raises(ValueError):
        pad_ballast(EncodedDataset(**fields), 4)


def test_warmup_pins_compile_cache(ws):
    """With warmup the steady state records zero recompiles; without it
    the first batch of each shape is counted."""
    j, churn = ws["j"], ws["churn"]
    props = {**churn, "bayesian.model.file.path": j("nb_model"),
             "serve.models": "naiveBayes", "serve.bucket.sizes": "1,2"}
    lines = read_lines(j("test.csv"))[:6]
    warm, _ = _batcher(props)
    try:
        _serve_all(warm, "naiveBayes", lines, burst=2)
        assert warm.counters.get("Serving.naiveBayes", "recompiles") == 0
        assert warm.ready
    finally:
        warm.close()
    cold, _ = _batcher({**props, "serve.warmup.on.start": "false"})
    try:
        assert not cold.ready
        _serve_all(cold, "naiveBayes", lines, burst=2)
        assert cold.counters.get("Serving.naiveBayes", "recompiles") >= 1
    finally:
        cold.close()


def test_shed_and_timeout_and_unknown_model(ws):
    j, churn = ws["j"], ws["churn"]
    props = {**churn, "bayesian.model.file.path": j("nb_model"),
             "serve.models": "naiveBayes"}
    line = read_lines(j("test.csv"))[0]
    b, _ = _batcher({**props, "serve.bucket.sizes": "64",
                     "serve.flush.deadline.ms": "5000",
                     "serve.queue.depth": "3"})
    try:
        held = [b.submit_nowait("naiveBayes", line) for _ in range(3)]
        with pytest.raises(ShedError):
            b.submit_nowait("naiveBayes", line)
        assert b.counters.get("Serving.naiveBayes", "shed") == 1
        with pytest.raises(UnknownModelError):
            b.submit_nowait("noSuchModel", line)
    finally:
        b.close()            # flushes the held requests
    assert all(h.wait(5.0) for h in held)
    bt, _ = _batcher({**props, "serve.bucket.sizes": "8",
                      "serve.flush.deadline.ms": "30",
                      "serve.request.timeout.ms": "1"})
    try:
        req = bt.submit_nowait("naiveBayes", line)
        time.sleep(0.05)
        with pytest.raises(RequestTimeout):
            req.wait(WAIT_S)
        assert bt.counters.get("Serving.naiveBayes", "timeouts") == 1
    finally:
        bt.close()


def test_tenant_label_door_shed_is_tenant_scoped(ws):
    """``tenant.id`` is a label: a full queue sheds a TenantShedError that
    names the tenant, the quota and a Retry-After estimate, and journals
    ``tenant.shed`` as the JAX package does."""
    from avenir_tpu_torch.serving.errors import TenantShedError

    j, churn = ws["j"], ws["churn"]
    b, _ = _batcher({**churn, "bayesian.model.file.path": j("nb_model"),
                     "serve.models": "naiveBayes", "tenant.id": "alpha",
                     "serve.bucket.sizes": "64",
                     "serve.flush.deadline.ms": "5000",
                     "serve.queue.depth": "1"})
    try:
        line = read_lines(j("test.csv"))[0]
        held = b.submit_nowait("naiveBayes", line)
        with pytest.raises(TenantShedError) as exc:
            b.submit_nowait("naiveBayes", line)
        assert exc.value.tenant == "alpha"
        assert exc.value.quota == "serve.queue.depth"
        assert 0.05 <= exc.value.retry_after_s <= 600.0
        assert b.counters.get("Tenant.alpha", "shed") == 1
    finally:
        b.close()
    assert held.wait(5.0)


def test_bad_request_rows_fail_typed(ws):
    j, churn = ws["j"], ws["churn"]
    b, _ = _batcher({**churn, "bayesian.model.file.path": j("nb_model"),
                     "serve.models": "naiveBayes",
                     "serve.bucket.sizes": "1"})
    try:
        with pytest.raises(RequestError):
            b.submit("naiveBayes", "too,few", timeout_s=WAIT_S)
    finally:
        b.close()
    vb, _ = _batcher({"hmm.model.file.path": j("hmm_model"),
                      "skip.field.count": "2", "serve.models": "viterbi",
                      "serve.bucket.sizes": "1",
                      "serve.sequence.pad.len": "4"})
    try:
        with pytest.raises(RequestError):        # unknown symbol
            vb.submit("viterbi", "u1,1,x,zzz", timeout_s=WAIT_S)
        with pytest.raises(RequestError):        # longer than the pad len
            vb.submit("viterbi", "u1,1,x,y,x,y,x", timeout_s=WAIT_S)
    finally:
        vb.close()


def test_bad_request_does_not_poison_batch_neighbors(ws):
    j, churn = ws["j"], ws["churn"]
    good = read_lines(j("test.csv"))[:3]
    b, _ = _batcher({**churn, "bayesian.model.file.path": j("nb_model"),
                     "serve.models": "naiveBayes",
                     "serve.bucket.sizes": "1,8",
                     "serve.flush.deadline.ms": "100"})
    try:
        oracle = [b.submit("naiveBayes", ln, timeout_s=WAIT_S) for ln in good]
        pend = [b.submit_nowait("naiveBayes", ln)
                for ln in [good[0], "too,few", good[1], good[2]]]
        assert pend[0].wait(WAIT_S) == oracle[0]
        with pytest.raises(RequestError):
            pend[1].wait(WAIT_S)
        assert [pend[2].wait(WAIT_S), pend[3].wait(WAIT_S)] == oracle[1:]
        assert b.counters.get("Serving.naiveBayes", "errors") == 1
    finally:
        b.close()


def test_registry_config_errors(ws):
    for props in ({}, {"serve.models": "hologram"},
                  {"serve.models": "naiveBayes"}):
        with pytest.raises(ConfigError):
            ModelRegistry.from_conf(JobConfig(props), device="cpu")


# ---------------------------------------------------------------------------
# front ends, without a socket
# ---------------------------------------------------------------------------

def _handle(srv, method, path, payload=None):
    """Drive ``srv``'s request handler on in-memory streams: (status,
    headers, body bytes)."""
    body = b"" if payload is None else json.dumps(payload).encode()
    h = srv.handler_class.__new__(srv.handler_class)
    h.rfile = io.BytesIO(body)
    h.wfile = io.BytesIO()
    h.path = path
    h.command = method
    h.request_version = "HTTP/1.1"
    h.requestline = f"{method} {path} HTTP/1.1"
    h.client_address = ("127.0.0.1", 0)
    h.close_connection = True
    h.headers = {"Content-Length": str(len(body))}
    getattr(h, f"do_{method}")()
    head, _, data = h.wfile.getvalue().partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    status = int(lines[0].split()[1])
    headers = dict(ln.split(": ", 1) for ln in lines[1:])
    return status, headers, data


def test_http_handlers_score_health_stats_metrics(ws):
    j, churn = ws["j"], ws["churn"]
    b, _ = _batcher({**churn, "bayesian.model.file.path": j("nb_model"),
                     "serve.models": "naiveBayes",
                     "serve.bucket.sizes": "1,4"})
    try:
        lines = read_lines(j("test.csv"))[:5]
        singles = [b.submit("naiveBayes", ln, timeout_s=WAIT_S)
                   for ln in lines]
        srv = ScoreHTTPServer(b, bind=False)
        assert srv.score_rows("naiveBayes", lines) == singles
        status, _h, body = _handle(srv, "POST", "/score",
                                   {"model": "naiveBayes", "rows": lines})
        assert status == 200 and json.loads(body)["results"] == singles
        status, _h, body = _handle(srv, "POST", "/score",
                                   {"model": "noSuch", "rows": lines[:1]})
        assert status == 404 and json.loads(body)["error"] == "UNKNOWN_MODEL"
        status, _h, _b = _handle(srv, "POST", "/score", {"rows": lines[:1]})
        assert status == 400
        status, _h, body = _handle(srv, "GET", "/healthz")
        health = json.loads(body)
        assert status == 200 and health["ready"]
        assert health["models"] == ["naiveBayes"]
        status, _h, body = _handle(srv, "GET", "/stats")
        stats = json.loads(body)
        assert stats["naiveBayes"]["requests"] >= 15
        assert stats["naiveBayes"]["process"] == "0"
        status, headers, body = _handle(srv, "GET", "/metrics")
        assert status == 200 and headers["Content-Type"].startswith(
            "text/plain")
        assert 'process="0"' in body.decode()
        assert _handle(srv, "GET", "/nowhere")[0] == 404
    finally:
        b.close()


def test_http_swap_builds_the_entry_on_the_server_device(ws):
    j, churn = ws["j"], ws["churn"]
    props = {**churn, "bayesian.model.file.path": j("nb_model")}
    b, registry = _batcher({**props, "serve.models": "naiveBayes",
                            "serve.bucket.sizes": "1"})
    try:
        srv = ScoreHTTPServer(b, bind=False, device="cpu")
        doc = srv.swap_model("naiveBayes", dict(props))
        assert doc == {"model": "naiveBayes", "version": 2}
        assert registry.get("naiveBayes").device.type == "cpu"
        status, _h, body = _handle(srv, "POST", "/swap",
                                   {"model": "naiveBayes", "props": props})
        assert status == 200 and json.loads(body)["version"] == 3
        status, _h, body = _handle(srv, "POST", "/swap",
                                   {"model": "naiveBayes", "props": {}})
        assert status == 400 and json.loads(body)["error"] == "BAD_REQUEST"
        assert b.counters.get("Serving.naiveBayes", "recompiles") == 0
    finally:
        b.close()


def test_queue_frontend_inproc(ws):
    from avenir_tpu_torch.pipeline.streaming import InProcQueue

    j, churn = ws["j"], ws["churn"]
    b, _ = _batcher({**churn, "bayesian.model.file.path": j("nb_model"),
                     "serve.models": "naiveBayes",
                     "serve.bucket.sizes": "1,4"})
    try:
        lines = read_lines(j("test.csv"))[:4]
        singles = [b.submit("naiveBayes", ln, timeout_s=WAIT_S)
                   for ln in lines]
        requests, responses = InProcQueue(), InProcQueue()
        fe = QueueScoreFrontend(b, requests, responses)
        for i, ln in enumerate(lines):
            requests.push(f"r{i},naiveBayes,{ln}")
        requests.push("r9,noSuchModel,x")
        requests.push("malformed-no-delims")
        assert fe.poll_once() == len(lines) + 2
        got = dict(msg.split(",", 1) for msg in responses.drain())
        for i in range(len(lines)):
            assert got[f"r{i}"] == singles[i]
        assert got["r9"].startswith("ERR,UNKNOWN_MODEL")
        assert got["malformed-no-delims"].startswith("ERR,BAD_REQUEST")
        assert fe.run(max_messages=1, idle_limit_s=0.05) == 0
    finally:
        b.close()


# ---------------------------------------------------------------------------
# the pipeline serve stage, the RL loop's schema
# ---------------------------------------------------------------------------

def test_scoring_plane_stage_in_pipeline(ws):
    """A pipeline trains NB then serves the test file through the online
    plane; the stage output equals the batch predictor's and the JAX
    package's pipeline's."""
    from avenir_tpu.pipeline.driver import Pipeline as JPipeline
    from avenir_tpu.pipeline.driver import Stage as JStage
    from avenir_tpu_torch.pipeline.driver import Pipeline, Stage

    j, churn = ws["j"], ws["churn"]
    get_job("BayesianPredictor").run(
        JobConfig({**churn, "bayesian.model.file.path": j("nb_model")}),
        j("test.csv"), j("nb_pred2"), device="cpu")
    batch = read_lines(j("nb_pred2"))
    serve_props = {"serve.models": "naiveBayes",
                   "bayesian.model.file.path": "@bayes_model",
                   "serve.queue.depth": "16", "serve.bucket.sizes": "1,4,16"}
    outs = []
    for P, S, C, ws_name in ((Pipeline, Stage, JobConfig, "serve_ws"),
                             (JPipeline, JStage, JConf, "serve_ws_jax")):
        p = (P(j(ws_name), C(dict(churn)), device="cpu") if P is Pipeline
             else P(j(ws_name), C(dict(churn))))
        p.bind("train", j("train.csv"))
        p.bind("test", j("test.csv"))
        p.add(S("bayesianDistr", "BayesianDistribution", "train",
                "bayes_model"))
        p.add(S("serve", "ScoringPlane", "test", "scored",
                props=dict(serve_props), uses=("bayes_model",)))
        counters = p.run()
        outs.append(read_lines(p.path("scored")))
        if P is Pipeline:
            serve_c = counters["serve"]
    assert outs[0] == outs[1] == batch
    assert serve_c.get("Serving.naiveBayes", "requests") == len(batch)
    assert serve_c.get("Serving.naiveBayes", "recompiles") == 0
    assert serve_c.get("Serving.naiveBayes", "shed") == 0
    assert serve_c.get("Serving.naiveBayes", "p99_us") > 0


def test_scoring_plane_journals_replay_and_request_spans(ws, tmp_path):
    """A traced replay journals ``serve.replay`` and one ``serve.request``
    span per row, each matching the telemetry schema."""
    from avenir_tpu_torch.telemetry import schema
    from avenir_tpu_torch.telemetry import spans as tel
    from avenir_tpu_torch.telemetry.journal import read_events

    j, churn = ws["j"], ws["churn"]
    conf = JobConfig({**churn, "bayesian.model.file.path": j("nb_model"),
                      "serve.models": "naiveBayes", "trace.on": "true",
                      "trace.journal.dir": str(tmp_path / "tel")})
    try:
        get_job("ScoringPlane").run(conf, j("test.csv"), j("traced_replay"),
                                    device="cpu")
        path = tel.tracer().journal_path
    finally:
        tel.tracer().disable()
    events = read_events(path)
    replay = [e for e in events if e["ev"] == "serve.replay"]
    assert len(replay) == 1 and replay[0]["rows"] == 120
    stamp = schema.STAMP_KEYS
    assert frozenset(set(replay[0]) - stamp) in schema.event_shapes(
        "serve.replay")
    spans = [e for e in events if e.get("ev") == "span.close"
             and e.get("name") == "serve.request"]
    assert len(spans) == 120
    assert all(s["attrs"]["model"] == "naiveBayes" for s in spans)


def test_rl_server_shares_serving_schema():
    from avenir_tpu_torch.models import online_rl as orl
    from avenir_tpu_torch.pipeline import streaming as st

    learner = orl.create_learner("intervalEstimator", ["a", "b"],
                                 {"min.reward.distr.sample": 5}, seed=3)
    srv = st.ReinforcementLearnerServer(
        learner, st.QueueEventSource(st.InProcQueue()),
        st.QueueRewardReader(st.InProcQueue()),
        st.QueueActionWriter(st.InProcQueue()), model_name="rlLoop")
    for i in range(20):
        srv.events.queue.push(f"ev{i},{i}")
    assert srv.run() == 20
    s = srv.stats()["rlLoop"]
    assert s["requests"] == 20 and s["batches"] == 20 and s["bucket.1"] == 20
    assert s["latency_samples"] == 20 and s["p99_ms"] >= s["p50_ms"] >= 0.0


def test_serving_stats_identity_equals_the_jax_package():
    from avenir_tpu.utils.metrics import Counters as JCounters
    from avenir_tpu.utils.metrics import LatencyTracker as JTracker
    from avenir_tpu.utils.metrics import serving_stats as jstats
    from avenir_tpu_torch.utils.metrics import (Counters, LatencyTracker,
                                                serving_stats)

    ident = {"process": "0", "replica": "r1"}
    outs = []
    for C, T, fn in ((Counters, LatencyTracker, serving_stats),
                     (JCounters, JTracker, jstats)):
        c, t = C(), T()
        c.increment("Serving.m", "requests", 3)
        c.increment("Serving.other", "shed")
        t.record(0.002)
        outs.append(fn(c, {"m": t}, identity=ident))
    assert outs[0] == outs[1]
    assert outs[0]["other"]["replica"] == "r1"


# ---------------------------------------------------------------------------
# what is refused, before any output
# ---------------------------------------------------------------------------

def test_tenant_contract_refused_before_output(ws, tmp_path):
    """A ``tenant.<id>.*`` contract, once refused, is honoured: the
    ScoringPlane replay under it equals the untenanted replay and each
    dispatch takes an arbiter slot under ``tenant.id``; a malformed
    contract is still refused before any output."""
    from avenir_tpu_torch import tenancy

    j, churn = ws["j"], ws["churn"]
    base = {**churn, "bayesian.model.file.path": j("nb_model"),
            "serve.models": "naiveBayes"}
    tenancy.reset()
    try:
        get_job("ScoringPlane").run(JobConfig(dict(base)), j("test.csv"),
                                    str(tmp_path / "plain"), device="cpu")
        props = {**base, "tenant.alpha.share": "2", "tenant.id": "alpha"}
        counters = get_job("ScoringPlane").run(
            JobConfig(dict(props)), j("test.csv"), str(tmp_path / "out"),
            device="cpu")
        assert (tmp_path / "out" / "part-00000").read_bytes() == \
            (tmp_path / "plain" / "part-00000").read_bytes()
        batches = counters.get("Serving.naiveBayes", "batches")
        assert batches
        assert tenancy.pool().stats()["alpha"]["grants"] == batches
        tenancy.reset()
        bad = {**base, "tenant.alpha.max.inflight": "2"}
        with pytest.raises(ConfigError, match="no tenant.alpha.share"):
            get_job("ScoringPlane").run(JobConfig(dict(bad)), j("test.csv"),
                                        str(tmp_path / "bad"), device="cpu")
        assert not (tmp_path / "bad").exists()
    finally:
        tenancy.reset()


def test_serving_cli_refusals_raise_before_binding(ws, tmp_path):
    from avenir_tpu_torch.serving.__main__ import main

    j, churn = ws["j"], ws["churn"]
    conf = tmp_path / "serve.properties"
    base = {**churn, "bayesian.model.file.path": j("nb_model"),
            "serve.models": "naiveBayes"}
    conf.write_text("".join(f"{k}={v}\n" for k, v in base.items()))
    # the tenant.* contract, fault.tenant.flood.after and the Redis
    # transport (tests/test_torch_resp.py) are honoured; without CUDA and
    # without --device cpu the CLI raises before binding
    import unittest.mock

    with unittest.mock.patch.object(torch.cuda, "is_available",
                                    lambda: False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--conf", str(conf)])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--conf", str(conf), "-D", "serve.request.queue=q"])


def test_fault_tenant_flood_refused_before_output():
    """``fault.tenant.flood.after``, once refused, is parsed as the JAX
    package parses it (the noisy-tenant drill's site); an unknown site is
    still refused."""
    from avenir_tpu_torch.utils.retry import FaultPlan

    plan = FaultPlan.from_conf(JobConfig({"fault.tenant.flood.after": "2"}))
    assert plan.schedule == {"tenant.flood": 2}
    assert FaultPlan.from_conf(JobConfig({})) is None
    with pytest.raises(ValueError, match="unknown fault sites"):
        FaultPlan({"tenant.flod": 1})


def test_scoring_plane_without_cuda_needs_the_cpu_asked_for(ws, tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    j, churn = ws["j"], ws["churn"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_job("ScoringPlane").run(
            JobConfig({**churn, "bayesian.model.file.path": j("nb_model"),
                       "serve.models": "naiveBayes"}),
            j("test.csv"), str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()

"""Serving CLI — ``python -m avenir_tpu_torch.serving --conf serve.properties
[-D key=value ...] [--http-port N] [--device cpu]``; port of
the JAX package's serving CLI (``avenir_tpu/serving/__main__.py``).

Loads every family in ``serve.models`` from the properties file's artifact
paths onto the device (``cuda`` unless ``--device cpu`` is given; without
CUDA it raises), warms every (model, bucket) shape and serves HTTP on
``serve.http.port`` (default 8390): ``POST /score``, ``POST /swap``,
``GET /healthz``, ``GET /stats``, ``GET /metrics``.  With ``pool.replicas``
(or ``pool.autoscale.on``) set the plane is a
:class:`~avenir_tpu_torch.serving.pool.ReplicaPool` on the one card.

``tenant.<id>.*`` contracts arm the tenancy arbiter before anything is
loaded: a plane with ``tenant.id`` then draws arbitrated dispatch slots
and sheds tenant-scoped 429s with ``Retry-After``.  Refused before the
port is bound, naming its ROADMAP.md item: ``serve.request.queue`` (the
Redis transport, Queue 1 item 7h-ii).

Runs until interrupted or sent SIGTERM; stats print once on shutdown.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from typing import List

from avenir_tpu_torch.core.config import JobConfig


def main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m avenir_tpu_torch.serving",
        description="the online scoring plane on one device")
    ap.add_argument("--conf", required=True,
                    help="properties file (serve.* keys + model artifacts)")
    ap.add_argument("--http-port", type=int, default=None,
                    help="override serve.http.port")
    ap.add_argument("-D", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="conf override (repeatable)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from avenir_tpu_torch import tenancy
    from avenir_tpu_torch.device import resolve_device
    from avenir_tpu_torch.serving.batcher import BucketedMicrobatcher
    from avenir_tpu_torch.serving.frontend import (
        ScoreHTTPServer,
        redis_score_frontend,
    )
    from avenir_tpu_torch.serving.pool import ReplicaPool
    from avenir_tpu_torch.serving.registry import ModelRegistry

    conf = JobConfig.from_file(args.conf)
    for item in args.overrides:
        key, eq, value = item.partition("=")
        if not eq or not key.strip():
            ap.error(f"-D expects KEY=VALUE, got {item!r}")
        conf.set(key.strip(), value.strip())
    # arm the tenant arbiter from tenant.* contracts (a no-op without
    # them; a malformed one raises before anything is bound or loaded)
    tenancy.configure(conf)
    # refused before anything is bound or loaded: the JAX package serves
    # a Redis list pair here
    if conf.get("serve.request.queue"):
        redis_score_frontend(None)         # raises: ROADMAP 7h-ii
    device = resolve_device(args.device)
    # telemetry from the same properties file the models load from
    # (trace.on / profile.on, both off by default); trace.writer.suffix
    # names the journal shard and the /metrics `replica` label
    from avenir_tpu_torch.telemetry import spans as tel
    from avenir_tpu_torch.telemetry.export import fleet_identity
    from avenir_tpu_torch.telemetry.slo import SloEvaluator

    tel.configure(conf)
    slo = SloEvaluator.from_conf(conf)
    # any pool.* arming serves a ReplicaPool behind the same frontends;
    # without it the plane stays one batcher
    if conf.get_int("pool.replicas", 0) or \
            conf.get_bool("pool.autoscale.on", False):
        # the frontend and the autoscaler share one evaluator, so its
        # violation latch journals one slo.violation per excursion
        batcher = ReplicaPool.from_conf(conf, slo=slo, device=device)
        health = batcher.health()
        names = health["models"]
        pool_note = f" x{len(health['replicas'])} replicas"
    else:
        registry = ModelRegistry.from_conf(conf, device=device)
        batcher = BucketedMicrobatcher.from_conf(registry, conf)
        names = registry.names()
        pool_note = ""
    port = (args.http_port if args.http_port is not None
            else conf.get_int("serve.http.port", 8390))
    # the writer suffix also rides /metrics as the `worker` label
    suffix = (conf.get("trace.writer.suffix")
              or tel.tracer().writer_suffix or None)
    http = ScoreHTTPServer(
        batcher, port=port, slo=slo, device=device,
        identity=fleet_identity(
            replica=suffix,
            tenant=conf.get("tenant.id"),
            worker=suffix)).start()
    print(f"serving {names} on "
          f"http://{http.address[0]}:{http.address[1]} "
          f"(buckets {batcher.buckets}){pool_note} on {device}"
          + (f" with {len(slo.rules)} SLO rule(s)" if slo else ""),
          flush=True)

    # SIGTERM stops a replica like Ctrl-C: the forensics bundle latches
    # the in-flight table first (a no-op without blackbox.dir), then the
    # graceful drain and the shutdown snapshot run
    import signal

    from avenir_tpu_torch.telemetry import blackbox

    stop = threading.Event()

    def _on_term(*_):
        blackbox.on_signal("SIGTERM")
        stop.set()

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:                       # pragma: no cover - non-main
        pass
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    finally:
        http.stop()
        batcher.close()
        # the final counter snapshot into the journal (a no-op untraced):
        # the post-hoc SLO gate's counter metrics read it
        tel.tracer().counters("serving", batcher.counters)
        print(json.dumps(batcher.stats()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

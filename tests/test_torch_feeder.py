"""The port's DeviceFeeder (``avenir_tpu_torch/runtime/feeder.py``) on the
CPU: the JAX package's feeder contracts (tests/test_native.py,
tests/test_scan.py) — order, error propagation, a consumer that stops
pulling stops the worker, ``close`` drops what was staged, an exhausted
feeder raises StopIteration again — and native chunks prefetched through
it equal the Python encoder's.
"""

import gc
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from avenir_tpu.runtime.feeder import DeviceFeeder as JFeeder  # noqa: E402
from avenir_tpu_torch.core.encoding import DatasetEncoder  # noqa: E402
from avenir_tpu_torch.core.schema import FeatureSchema  # noqa: E402
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)
from avenir_tpu_torch.runtime import prefetch_encoded  # noqa: E402
from avenir_tpu_torch.runtime.feeder import DeviceFeeder, map_arrays  # noqa: E402


def test_order_and_error_propagation_as_the_jax_feeder():
    items = [np.full((4,), i) for i in range(10)]
    got = [int(x[0]) for x in DeviceFeeder(items, depth=3, device="cpu")]
    assert got == [int(x[0]) for x in JFeeder(items, depth=3)] == list(range(10))

    def bad_gen():
        yield np.zeros(2)
        raise RuntimeError("boom")

    feeder = DeviceFeeder(bad_gen(), device="cpu")
    next(feeder)
    with pytest.raises(RuntimeError, match="boom"):
        list(feeder)


def test_cpu_stage_is_the_identity():
    arr = np.arange(6, dtype=np.int32)
    (out,) = list(DeviceFeeder([arr], device="cpu"))
    assert out is arr


def test_a_stage_error_reaches_the_consumer():
    def stage(x):
        if x == 3:
            raise ValueError("bad chunk 3")
        return x

    feeder = DeviceFeeder(range(10), depth=2, stage=stage, device="cpu")
    assert [next(feeder) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError, match="bad chunk 3"):
        next(feeder)


def test_abandonment_stops_the_worker():
    produced = []

    def gen():
        for i in range(100_000):
            produced.append(i)
            yield np.full((4,), i)

    feeder = DeviceFeeder(gen(), depth=2, device="cpu")
    next(feeder)
    worker = feeder._thread
    feeder.close()
    worker.join(timeout=5.0)
    assert not worker.is_alive()
    assert len(produced) < 100_000

    # a feeder dropped without close (the fit raised) stops its worker too
    produced.clear()
    feeder2 = DeviceFeeder(gen(), depth=2, device="cpu")
    it = iter(feeder2)
    next(it)
    worker2 = feeder2._thread
    del feeder2, it
    gc.collect()
    worker2.join(timeout=10.0)
    assert not worker2.is_alive()
    assert len(produced) < 100_000


def test_close_drops_staged_items():
    feeder = DeviceFeeder(iter(range(100)), depth=4, stage=lambda x: x,
                          device="cpu")
    next(iter(feeder))
    feeder.close()
    assert not feeder._thread.is_alive()
    assert feeder._q.empty()
    with pytest.raises(StopIteration):
        next(iter(feeder))


def test_exhausted_feeder_raises_stopiteration_again():
    feeder = DeviceFeeder([np.zeros(2)], depth=2, device="cpu")
    assert len(list(feeder)) == 1
    with pytest.raises(StopIteration):
        next(feeder)

    def bad_gen():
        yield np.zeros(2)
        raise RuntimeError("boom")

    f2 = DeviceFeeder(bad_gen(), device="cpu")
    next(f2)
    with pytest.raises(RuntimeError, match="boom"):
        next(f2)
    with pytest.raises(StopIteration):         # the error was delivered once
        next(f2)


def test_map_arrays_reaches_a_chunk_and_leaves_ids_and_cursors():
    enc = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))
    ds = enc.transform(generate_hosp_readmit(20, seed=1))
    cur = {"file": "f", "rows": 20}
    got, cur2 = map_arrays((ds, cur), torch.from_numpy)
    assert isinstance(got.codes, torch.Tensor)
    assert isinstance(got.cont, torch.Tensor)
    assert isinstance(got.labels, torch.Tensor)
    assert got.ids is ds.ids and cur2 is cur
    assert got.num_rows == 20 and got.slice(5, 9).num_rows == 4


def test_prefetch_encoded_equals_the_python_encoder(tmp_path):
    rows = generate_hosp_readmit(600, seed=6)
    path = tmp_path / "h.csv"
    path.write_text("\n".join(",".join(r) for r in rows) + "\n")
    (tmp_path / "h.json").write_text(json.dumps(HOSP_SCHEMA_JSON))
    enc = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))
    chunks = list(prefetch_encoded(str(path), enc, ncols=12,
                                   chunk_bytes=8192, device="cpu"))
    assert len(chunks) > 1
    want = enc.transform(rows)
    np.testing.assert_array_equal(np.concatenate([c.codes for c in chunks]),
                                  want.codes)
    np.testing.assert_array_equal(np.concatenate([c.labels for c in chunks]),
                                  want.labels)

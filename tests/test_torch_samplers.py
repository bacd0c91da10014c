"""The port's samplers, RandomForest and sampler jobs held against the JAX
package on the CPU, on the same seeds and inputs.

- ``bootstrap_indices``, ``bagging_sample``, ``undersample_mask`` and
  ``undersample`` equal the JAX package's exactly (the draws are
  ``utils/prng.py``'s copy of ``jax.random``); ``StreamingUnderSampler``
  keeps the same rows chunk by chunk.
- ``RandomForest``: every tree structurally identical under the tree
  contract (ROADMAP.md "Port contracts", scores within 1e-6), votes within
  1e-6.  The forest seed is one where no tree's split sits within
  rounding of the JAX package's degenerate-candidate rule or of a near-tie
  between two candidates (Queue 3); seed 3 is pinned where a near-tie
  parts the two packages' trees.
- ``BaggingSampler`` and ``UnderSamplingBalancer`` through both CLIs: part
  files byte-identical, counters equal.
"""

import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from avenir_tpu.__main__ import main as jax_main  # noqa: E402
from avenir_tpu.core.encoding import DatasetEncoder as JEncoder  # noqa: E402
from avenir_tpu.core.schema import FeatureSchema as JSchema  # noqa: E402
from avenir_tpu.models import samplers as jsamplers  # noqa: E402
from avenir_tpu.models import tree as jtree  # noqa: E402
from avenir_tpu_torch.__main__ import main as torch_main  # noqa: E402
from avenir_tpu_torch.core.csv_io import write_csv  # noqa: E402
from avenir_tpu_torch.core.encoding import DatasetEncoder  # noqa: E402
from avenir_tpu_torch.core.schema import FeatureSchema  # noqa: E402
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)
from avenir_tpu_torch.datagen.retarget import (  # noqa: E402
    RETARGET_SCHEMA_JSON, generate_retarget)
from avenir_tpu_torch.models import samplers, tree  # noqa: E402
from avenir_tpu_torch.utils import prng  # noqa: E402

from test_torch_tree import assert_same_tree  # noqa: E402

VOTE_TOL = 1e-6


def _encode(schema_json, rows):
    ds = DatasetEncoder(FeatureSchema.from_json(schema_json)).fit_transform(rows)
    jds = JEncoder(JSchema.from_json(schema_json)).fit_transform(rows)
    return ds, jds


@pytest.fixture(scope="module")
def hosp():
    return _encode(HOSP_SCHEMA_JSON, generate_hosp_readmit(3000, seed=4))


def _same_dataset(got, want):
    for name in ("codes", "cont", "labels", "ids"):
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(g, torch.Tensor):
            g = g.cpu().numpy()
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


@pytest.mark.parametrize("n,k", [(1, None), (7, None), (1000, None),
                                 (1000, 250), (3, 40)])
def test_bootstrap_indices_equal_jax(n, k):
    for seed in (0, 5, 123):
        want = jsamplers.bootstrap_indices(jax.random.PRNGKey(seed), n, k)
        got = samplers.bootstrap_indices(prng.prng_key(seed), n, k)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("on_tensor", [False, True])
def test_bagging_and_undersample_equal_jax(hosp, on_tensor):
    ds, jds = hosp
    if on_tensor:               # a chunk the feeder staged as tensors
        ds = samplers._take(ds, np.arange(ds.num_rows))
        ds.codes, ds.cont, ds.labels = (torch.from_numpy(a) for a in
                                        (ds.codes, ds.cont, ds.labels))
    for seed in (1, 2):
        _same_dataset(samplers.bagging_sample(prng.prng_key(seed), ds),
                      jsamplers.bagging_sample(jax.random.PRNGKey(seed), jds))
        _same_dataset(samplers.undersample(prng.prng_key(seed), ds),
                      jsamplers.undersample(jax.random.PRNGKey(seed), jds))


@pytest.mark.parametrize("counts", [[900, 100, 0], [5, 5, 5], [1, 40000, 7]])
def test_undersample_mask_equals_jax(counts):
    rng = np.random.default_rng(8)
    labels = rng.integers(0, 3, size=2001).astype(np.int32)
    for seed in (0, 9):
        want = jsamplers.undersample_mask(jax.random.PRNGKey(seed),
                                          jnp.asarray(labels),
                                          jnp.asarray(counts))
        got = samplers.undersample_mask(prng.prng_key(seed), labels, counts)
        np.testing.assert_array_equal(got, np.asarray(want))
        got_t = samplers.undersample_mask(prng.prng_key(seed),
                                          torch.from_numpy(labels), counts)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want))


@pytest.mark.parametrize("bootstrap_rows", [0, 700, 10_000])
def test_streaming_undersampler_equals_jax_chunk_by_chunk(hosp, bootstrap_rows):
    ds, jds = hosp
    bounds = [(0, 500), (500, 1200), (1200, 2100), (2100, 3000)]
    got = list(samplers.StreamingUnderSampler(
        prng.prng_key(3), bootstrap_rows).process(
            ds.slice(a, b) for a, b in bounds))
    want = list(jsamplers.StreamingUnderSampler(
        jax.random.PRNGKey(3), bootstrap_rows).process(
            jds.slice(a, b) for a, b in bounds))
    assert len(got) == len(want) == len(bounds)
    for g, w in zip(got, want):
        _same_dataset(g, w)


# forest seeds on this data: 0, 1, 4 and 6 grow the JAX package's trees;
# 2, 5 and 7 part where the JAX package's float32 rounding leaves a
# degenerate candidate on top (Queue 3's first entry), and 3 also at a
# near-tie (test_pin_forest_seed3_parts_at_a_near_tie)
FOREST_SEED = 1


def _forests(seed):
    ds, jds = _encode(RETARGET_SCHEMA_JSON, generate_retarget(6000, seed=9))
    is_cat = [f.is_categorical for f in
              FeatureSchema.from_json(RETARGET_SCHEMA_JSON).binned_feature_fields]
    kw = dict(num_trees=3, seed=seed, max_depth=3, min_node_size=64)
    jforest = jtree.RandomForest(**kw)
    forest = tree.RandomForest(device="cpu", **kw)
    return (ds, jds, forest, forest.fit(ds, is_cat), jforest,
            jforest.fit(jds, is_cat))


def test_random_forest_equals_jax():
    ds, jds, forest, got, jforest, want = _forests(FOREST_SEED)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_same_tree(g.to_string(), w.to_string())
    pred, votes = forest.predict(got, ds)
    jpred, jvotes = jforest.predict(want, jds)
    np.testing.assert_allclose(votes, jvotes, rtol=0, atol=VOTE_TOL)
    np.testing.assert_array_equal(pred, jpred)


def test_pin_forest_seed3_parts_at_a_near_tie():
    """Seed 3, tree 2, node 2 (2145 / 576 rows): the port takes
    attr0:cat:000000111 (0.01438262), the JAX package attr0:cat:000001000
    (0.01438269), two candidates 7e-8 apart, under the float32 rounding
    both packages' scores carry (the tree contract's 1e-6)."""
    _ds, _jds, _f, got, _jf, want = _forests(3)
    g = json.loads(got[2].to_string())["nodes"]
    w = json.loads(want[2].to_string())["nodes"]
    assert [n["split"] for n in g[:2]] == [n["split"] for n in w[:2]]
    assert g[2]["counts"] == w[2]["counts"] == [2145.0, 576.0]
    assert g[2]["split"]["key"] == "attr0:cat:000000111"
    assert w[2]["split"]["key"] == "attr0:cat:000001000"
    assert abs(g[2]["score"] - w[2]["score"]) < 1e-6


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def sampler_outputs(tmp_path_factory):
    work = tmp_path_factory.mktemp("samplers")
    write_csv(str(work / "train.csv"), generate_hosp_readmit(2500, seed=6))
    (work / "hosp.json").write_text(json.dumps(HOSP_SCHEMA_JSON))
    out = {}
    for pkg, main, extra in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", "cpu"])):
        for job, keys in (("BaggingSampler", ["-Dbatch.size=700",
                                              "-Dseed=11"]),
                          ("UnderSamplingBalancer", ["-Dseed=5"])):
            o = work / f"{pkg}_{job}"
            counters = _run(main, [
                job, f"-Dfeature.schema.file.path={work / 'hosp.json'}",
                *keys, str(work / "train.csv"), str(o), *extra])
            out[pkg, job] = ((o / "part-00000").read_bytes(), counters)
    return out


@pytest.mark.parametrize("job", ["BaggingSampler", "UnderSamplingBalancer"])
def test_sampler_jobs_byte_identical(sampler_outputs, job):
    got, got_counters = sampler_outputs["torch", job]
    want, want_counters = sampler_outputs["jax", job]
    assert got == want
    assert got_counters == want_counters
    assert "Emitted=" in got_counters

"""The port's Markov family held against the JAX package on the CPU, on
the same seeded inputs.

- ``ops/agg.py``'s ``segment_count``, ``transition_counts`` and
  ``weighted_transition_counts``: equal to the JAX package's (−1 codes
  count nothing; the weighted sums are exact dyadic sums, so equal too).
- ``MarkovChain`` and ``HMMBuilder`` (fully and partially tagged, whole and
  in chunks): counts equal, model lines byte-identical.
- ``ViterbiDecoder``: ``"scan"`` paths equal the JAX package's integer for
  integer on random (tie-free) tables, ragged; ``"assoc"`` equal to the
  scan on the JAX package's own promise (its
  ``tests/test_markov.py::test_viterbi_assoc_matches_scan`` data) and on
  longer records.
- The three jobs through both CLIs: part files byte-identical, counters
  equal; ``stream.checkpoint.dir`` raises the same error.
- ``convert.markov_model_from_jax`` / ``hmm_model_from_jax``: a JAX-built
  model, converted, writes the same lines and decodes the same paths.
- The four constructors take a data mesh and fit, count and decode under
  it as on one device (``tests/test_torch_model_mesh.py`` holds the
  meshed models against the JAX package's).
"""

import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from avenir_tpu.__main__ import main as jax_main  # noqa: E402
from avenir_tpu.models import markov as jmk  # noqa: E402
from avenir_tpu.ops import agg as jagg  # noqa: E402
from avenir_tpu_torch import convert  # noqa: E402
from avenir_tpu_torch.__main__ import main as torch_main  # noqa: E402
from avenir_tpu_torch.datagen import hmm_seq  # noqa: E402
from avenir_tpu_torch.datagen.event_seq import (  # noqa: E402
    STATES, generate_xaction_sequences, sequences_to_rows)
from avenir_tpu_torch.models import markov as mk  # noqa: E402
from avenir_tpu_torch.ops import agg  # noqa: E402

CPU = "cpu"
S_NAMES = [f"s{i}" for i in range(6)]
O_NAMES = [f"o{i}" for i in range(12)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("n,na,nb", [(0, 3, 4), (1, 1, 1), (5000, 6, 12),
                                     (777, 9, 9)])
def test_count_ops_equal_jax(n, na, nb):
    rng = np.random.default_rng(n)
    a = rng.integers(-1, na + 1, size=n).astype(np.int32)   # −1 and na drop
    b = rng.integers(-1, nb, size=n).astype(np.int32)
    w = rng.choice([1.0, 0.75, 0.5, 0.25], size=n).astype(np.float32)
    np.testing.assert_array_equal(
        agg.segment_count(_t(a), na).numpy(),
        np.asarray(jagg.segment_count(jnp.asarray(a), na)))
    np.testing.assert_array_equal(
        agg.transition_counts(_t(a), _t(b), na, nb).numpy(),
        np.asarray(jagg.transition_counts(jnp.asarray(a), jnp.asarray(b),
                                          na, nb)))
    got = agg.weighted_transition_counts(_t(a), _t(b), _t(w), na, nb)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jagg.weighted_transition_counts(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(w), na, nb)))


def test_count_ops_keep_the_chunk_cap():
    big = torch.zeros(agg.MAX_EXACT_CHUNK_ROWS, dtype=torch.int8)
    with pytest.raises(ValueError, match="exact-count limit"):
        agg.transition_counts(big, big, 2, 2)


@pytest.fixture(scope="module")
def chain_seqs():
    seqs, _ = generate_xaction_sequences(300, seed=5)
    return seqs


@pytest.mark.parametrize("scale", [None, 1000])
@pytest.mark.parametrize("declared", [False, True])
def test_markov_chain_lines_byte_identical(chain_seqs, scale, declared):
    enc = mk.SequenceEncoder(STATES) if declared else None
    jenc = jmk.SequenceEncoder(STATES) if declared else None
    model, got_enc = mk.MarkovChain(scale=scale, device=CPU).fit(
        chain_seqs, encoder=enc)
    jmodel, _ = jmk.MarkovChain(scale=scale).fit(chain_seqs, encoder=jenc)
    np.testing.assert_array_equal(model.counts, jmodel.counts)
    assert model.to_lines() == jmodel.to_lines()
    chunks = [chain_seqs[i:i + 70] for i in range(0, len(chain_seqs), 70)]
    streamed, _ = mk.MarkovChain(scale=scale, device=CPU).fit_chunks(
        chunks, got_enc)
    assert streamed.to_lines() == model.to_lines()


@pytest.fixture(scope="module")
def hmm_data():
    a, b, pi = hmm_seq.planted_hmm(seed=2)
    states, obs = hmm_seq.sample_hmm(a, b, pi, 300, 5, 30, seed=4)
    return a, b, pi, states, obs


def test_hmm_tagged_lines_byte_identical(hmm_data):
    *_, states, obs = hmm_data
    rows = hmm_seq.tagged_rows(states, obs, S_NAMES, O_NAMES)
    seqs = [[tuple(t.split(":")) for t in r[1:]] for r in rows]
    model = mk.HMMBuilder(device=CPU).fit_tagged(seqs)
    jmodel = jmk.HMMBuilder().fit_tagged(seqs)
    assert model.to_lines() == jmodel.to_lines()
    st, ob = mk.SequenceEncoder(S_NAMES), mk.SequenceEncoder(O_NAMES)
    chunked = mk.HMMBuilder(device=CPU).fit_tagged_chunks(
        [seqs[i:i + 64] for i in range(0, len(seqs), 64)], st, ob)
    jchunked = jmk.HMMBuilder().fit_tagged_chunks(
        [seqs[i:i + 64] for i in range(0, len(seqs), 64)],
        jmk.SequenceEncoder(S_NAMES), jmk.SequenceEncoder(O_NAMES))
    assert chunked.to_lines() == jchunked.to_lines()


@pytest.mark.parametrize("window", [(1.0, 0.75, 0.5, 0.25), (1.0, 0.5)])
def test_hmm_partially_tagged_lines_byte_identical(hmm_data, window):
    *_, states, obs = hmm_data
    rows = hmm_seq.partial_rows(states, obs, S_NAMES, O_NAMES)
    seqs = [r[1:] for r in rows]
    model = mk.HMMBuilder(device=CPU).fit_partially_tagged(
        seqs, S_NAMES, window_function=window)
    jmodel = jmk.HMMBuilder().fit_partially_tagged(
        seqs, S_NAMES, window_function=window)
    assert model.to_lines() == jmodel.to_lines()
    chunks = [seqs[i:i + 50] for i in range(0, len(seqs), 50)]
    got = mk.HMMBuilder(device=CPU).fit_partially_tagged_chunks(
        chunks, S_NAMES, mk.SequenceEncoder(O_NAMES), window_function=window)
    want = jmk.HMMBuilder().fit_partially_tagged_chunks(
        chunks, S_NAMES, jmk.SequenceEncoder(O_NAMES),
        window_function=window)
    assert got.to_lines() == want.to_lines()


def _random_model(rng, s, o):
    return (rng.dirichlet(np.ones(s), size=s), rng.dirichlet(np.ones(o), size=s),
            rng.dirichlet(np.ones(s)))


def _models(a, b, pi):
    names = ([f"s{i}" for i in range(a.shape[0])],
             [f"o{i}" for i in range(b.shape[1])])
    return (mk.HMMModel(*names, a, b, pi), jmk.HMMModel(*names, a, b, pi))


@pytest.mark.parametrize("s,o,r,t", [(5, 7, 12, 40), (6, 12, 64, 90),
                                     (2, 3, 9, 1), (3, 4, 20, 130)])
def test_viterbi_scan_equals_jax(s, o, r, t):
    rng = np.random.default_rng(s * 100 + t)
    model, jmodel = _models(*_random_model(rng, s, o))
    obs = rng.integers(0, o, size=(r, t)).astype(np.int32)
    lens = rng.integers(0, t + 1, size=r)
    obs[np.arange(t)[None, :] >= lens[:, None]] = -1     # ragged, some empty
    want = jmk.ViterbiDecoder(jmodel, method="scan").decode_codes(obs)
    got = mk.ViterbiDecoder(model, method="scan", device=CPU).decode_codes(obs)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["jax_promise", "long"])
def test_viterbi_assoc_equals_scan(case):
    """The JAX package promises assoc == scan on its test's data (5 states,
    7 observations, 12 × 40 with two ragged rows); the port holds the same
    promise, against its own scan and the JAX package's."""
    rng = np.random.default_rng(0 if case == "jax_promise" else 17)
    model, jmodel = _models(*_random_model(rng, 5, 7))
    t = 40 if case == "jax_promise" else 150
    obs = rng.integers(0, 7, size=(12, t)).astype(np.int32)
    obs[3, 25:] = -1
    obs[7, 10:] = -1
    scan = mk.ViterbiDecoder(model, method="scan", device=CPU).decode_codes(obs)
    assoc = mk.ViterbiDecoder(model, method="assoc",
                              device=CPU).decode_codes(obs)
    np.testing.assert_array_equal(assoc, scan)
    np.testing.assert_array_equal(
        assoc, jmk.ViterbiDecoder(jmodel, method="scan").decode_codes(obs))


def test_viterbi_decode_and_predictor_lines_equal_jax(hmm_data):
    a, b, pi, states, obs = hmm_data
    model, jmodel = _models(a, b, pi)
    rows = hmm_seq.code_rows(obs[:40], O_NAMES)
    seqs = [r[1:] for r in rows]
    assert (mk.ViterbiDecoder(model, device=CPU).decode(seqs, pad_to=32)
            == jmk.ViterbiDecoder(jmodel).decode(seqs, pad_to=32))
    with pytest.raises(ValueError, match="exceeds pad_to"):
        mk.ViterbiDecoder(model, device=CPU).decode(seqs, pad_to=3)
    for pair in (False, True):
        got = mk.ViterbiStatePredictor(model, pair_output=pair,
                                       device=CPU).predict_lines(rows)
        want = jmk.ViterbiStatePredictor(jmodel,
                                         pair_output=pair).predict_lines(rows)
        assert got == want


def test_convert_models_from_jax(hmm_data, chain_seqs):
    a, b, pi, _states, obs = hmm_data
    jmodel = jmk.HMMBuilder().fit_tagged(
        [[tuple(t.split(":")) for t in r[1:]]
         for r in hmm_seq.tagged_rows(*hmm_data[3:], S_NAMES, O_NAMES)])
    for src in (jmodel, jmodel.to_lines()):
        model = convert.hmm_model_from_jax(src)
        assert model.to_lines() == jmodel.to_lines()
        np.testing.assert_array_equal(
            mk.ViterbiDecoder(model, device=CPU).decode_codes(obs[:50]),
            jmk.ViterbiDecoder(jmodel).decode_codes(obs[:50]))
    bad = jmk.HMMModel(jmodel.states, jmodel.observations[:-1],
                       jmodel.transition, jmodel.emission, jmodel.initial)
    with pytest.raises(ValueError, match="emission"):
        convert.hmm_model_from_jax(bad)
    jchain, _ = jmk.MarkovChain(scale=None).fit(chain_seqs)
    chain = convert.markov_model_from_jax(jchain)
    assert chain.to_lines() == jchain.to_lines()
    back = convert.markov_model_from_jax(jchain.to_lines())
    np.testing.assert_allclose(back.transition_probs(),
                               jchain.transition_probs(), rtol=1e-15)


def test_constructors_accept_a_mesh_and_fit_under_it(chain_seqs, hmm_data):
    from avenir_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(("data",), device=CPU)
    assert mesh.size("data") == 8
    chain, _ = mk.MarkovChain(mesh=mesh, device=CPU).fit(chain_seqs)
    assert chain.to_lines() == mk.MarkovChain(device=CPU).fit(
        chain_seqs)[0].to_lines()
    *_, states, obs = hmm_data
    rows = hmm_seq.tagged_rows(states, obs, S_NAMES, O_NAMES)
    seqs = [[tuple(t.split(":")) for t in r[1:]] for r in rows]
    hmm = mk.HMMBuilder(mesh=mesh, device=CPU).fit_tagged(seqs)
    assert hmm.to_lines() == mk.HMMBuilder(device=CPU).fit_tagged(
        seqs).to_lines()
    decoder = mk.ViterbiDecoder(hmm, mesh=mesh, device=CPU)
    np.testing.assert_array_equal(
        decoder.decode_codes(obs),
        mk.ViterbiDecoder(hmm, device=CPU).decode_codes(obs))
    plain = hmm_seq.code_rows(obs, O_NAMES)
    predictor = mk.ViterbiStatePredictor(hmm, mesh=mesh, device=CPU)
    assert predictor.decoder.mesh is mesh
    assert predictor.predict_lines(plain) == mk.ViterbiStatePredictor(
        hmm, device=CPU).predict_lines(plain)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _write(path, rows):
    path.write_text("".join(",".join(r) + "\n" for r in rows))


JOB_CASES = {
    "chain": ("MarkovStateTransitionModel", "chain.csv", []),
    "chain_scaled_streamed": ("MarkovStateTransitionModel", "chain.csv",
                              ["-Dtrans.prob.scale=1000",
                               "-Dstream.chunk.rows=90",
                               f"-Dmodel.states={','.join(STATES)}"]),
    "hmm_tagged": ("HiddenMarkovModelBuilder", "tagged.csv", []),
    "hmm_tagged_streamed": ("HiddenMarkovModelBuilder", "tagged.csv",
                            ["-Dstream.chunk.rows=70",
                             f"-Dmodel.states={','.join(S_NAMES)}",
                             f"-Dmodel.observations={','.join(O_NAMES)}"]),
    "hmm_partial": ("HiddenMarkovModelBuilder", "partial.csv",
                    ["-Dpartially.tagged=true",
                     f"-Dmodel.states={','.join(S_NAMES)}"]),
    "hmm_partial_streamed": ("HiddenMarkovModelBuilder", "partial.csv",
                             ["-Dpartially.tagged=true",
                              "-Dstream.chunk.rows=70",
                              f"-Dmodel.states={','.join(S_NAMES)}",
                              f"-Dmodel.observations={','.join(O_NAMES)}"]),
    "viterbi": ("ViterbiStatePredictor", "obs.csv", []),
    "viterbi_pairs": ("ViterbiStatePredictor", "obs.csv",
                      ["-Doutput.state.only=false"]),
}


@pytest.fixture(scope="module")
def job_outputs(tmp_path_factory, chain_seqs, hmm_data):
    work = tmp_path_factory.mktemp("markov")
    *_, states, obs = hmm_data
    _write(work / "chain.csv", sequences_to_rows(chain_seqs))
    _write(work / "tagged.csv", hmm_seq.tagged_rows(states, obs, S_NAMES,
                                                    O_NAMES))
    _write(work / "partial.csv", hmm_seq.partial_rows(states, obs, S_NAMES,
                                                      O_NAMES))
    _write(work / "obs.csv", hmm_seq.code_rows(obs, O_NAMES))
    out = {}
    for pkg, main, extra in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", "cpu"])):
        model_dir = work / f"{pkg}_hmm_tagged"
        for case, (job, inp, keys) in JOB_CASES.items():
            o = work / f"{pkg}_{case}"
            if job == "ViterbiStatePredictor":
                keys = keys + [f"-Dhmm.model.file.path={model_dir}"]
            counters = _run(main, [job, *keys, str(work / inp), str(o),
                                   *extra])
            out[pkg, case] = ((o / "part-00000").read_bytes(), counters)
    return work, out


@pytest.mark.parametrize("case", list(JOB_CASES))
def test_markov_jobs_byte_identical(job_outputs, case):
    _work, out = job_outputs
    got, got_counters = out["torch", case]
    want, want_counters = out["jax", case]
    assert got == want
    assert got_counters == want_counters


@pytest.mark.parametrize("job,extra", [
    ("MarkovStateTransitionModel", [f"-Dmodel.states={','.join(STATES)}"]),
    ("HiddenMarkovModelBuilder", [f"-Dmodel.states={','.join(S_NAMES)}",
                                  f"-Dmodel.observations={','.join(O_NAMES)}"]),
])
def test_stream_checkpoint_refused_as_jax_refuses(job_outputs, job, extra):
    work, _out = job_outputs
    inp = work / ("chain.csv" if job.startswith("Markov") else "tagged.csv")
    errors = []
    for main, dev in ((jax_main, []), (torch_main, ["--device", "cpu"])):
        with pytest.raises(Exception) as ei:
            _run(main, [job, "-Dstream.chunk.rows=50",
                        f"-Dstream.checkpoint.dir={work / 'ck'}", *extra,
                        str(inp), str(work / "refused"), *dev])
        errors.append((type(ei.value).__name__, str(ei.value)))
    assert errors[0] == errors[1]
    assert "stream.checkpoint.dir is not supported" in errors[0][1]
    assert not (work / "refused").exists()


@pytest.mark.parametrize("rows", ["code_rows", "tagged_rows",
                                  "partial_rows"])
def test_row_ids_refuse_past_their_seven_digit_width(rows):
    """The ``C{r:07d}`` row ids sort as their numbers only below 10**7
    rows: the writers refuse more."""
    codes = np.zeros((10 ** 7 + 1, 0), np.int32)
    args = ((codes, O_NAMES) if rows == "code_rows"
            else (codes, codes, S_NAMES, O_NAMES))
    with pytest.raises(ValueError, match="7-digit row-id width"):
        getattr(hmm_seq, rows)(*args)

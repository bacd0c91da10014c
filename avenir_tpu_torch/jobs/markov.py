"""Sequence-model jobs — Markov chain trainer, HMM builder and Viterbi
predictor (markov/MarkovStateTransitionModel.java,
HiddenMarkovModelBuilder.java, ViterbiStatePredictor.java); port of
``avenir_tpu/jobs/markov.py``.

Input rows are ``id, token, token, ...`` sequences; sub-token structure
(``obs:state``) follows ``sub.field.delim``.
"""

from __future__ import annotations

from typing import List

from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.jobs.base import Job, input_files, read_lines, write_output
from avenir_tpu_torch.models import markov as mk
from avenir_tpu_torch.utils.metrics import Counters


def _seq_rows(path: str, delim: str) -> List[List[str]]:
    """Sequence files are ragged (one row per record, any length): raw
    lines split on ``delim``, not the rectangular CSV reader."""
    rows: List[List[str]] = []
    for f in input_files(path):
        with open(f) as fh:
            for line in fh:
                line = line.rstrip("\n").rstrip("\r")
                if line:
                    rows.append(line.split(delim))
    return rows


def _sequences(path: str, delim: str, skip: int = 1) -> List[List[str]]:
    return [[t for t in row[skip:] if t != ""] for row in _seq_rows(path, delim)]


def _fit_streaming(job: Job, conf: JobConfig, input_path: str,
                   counters: Counters, fit_chunks_fn, delim: str, skip: int):
    """Streamed sequence-model fit: ``stream.chunk.rows`` lines at a time
    with per-chunk retry; in a fleet the chunks are owned round robin and
    the partial counts merged at the end of the stream
    (``Job.distributed_plan``).  Sets ``Records::Processed`` to the global
    sequence count on every process."""
    if conf.get("stream.checkpoint.dir"):
        raise ConfigError(
            "stream.checkpoint.dir is not supported on the sequence-model "
            "streaming path (no cursor snapshots are wired for ragged line "
            "streams yet) — configuring it must fail loudly rather than "
            "silently run without durability; rely on per-chunk retry + "
            "job re-run, or unset the key")
    owner, acc, distributed = job.distributed_plan(conf, None)
    box = {"n": 0}

    def seq_chunks():
        for lines in job.iter_line_chunks_retrying(conf, input_path,
                                                   counters, owner=owner):
            box["n"] += len(lines)
            yield [[t for t in ln.split(delim)[skip:] if t != ""]
                   for ln in lines]

    merged: dict = {}
    data = seq_chunks()
    if distributed:
        data = job.distributed_stream(data, acc, lambda: box["n"], merged)
        model = job.distributed_fit(
            lambda d: fit_chunks_fn(d, acc), data, acc, merged)
    else:
        model = fit_chunks_fn(data, acc)
    counters.set("Records", "Processed",
                 merged["rows"] if distributed else box["n"])
    return model


class MarkovStateTransitionModel(Job):
    """First-order transition matrix with Laplace smoothing; int-scaled rows
    when ``trans.prob.scale`` > 1 (StateTransitionProbability.java:65-95)."""

    name = "MarkovStateTransitionModel"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        delim = conf.field_delim_regex
        skip = conf.get_int("skip.field.count", 1)
        states = conf.get_list("model.states")
        enc = mk.SequenceEncoder(states) if states else None
        scale = conf.get_int("trans.prob.scale", 1)
        chain = mk.MarkovChain(
            laplace=conf.get_float("laplace.smoothing", 1.0),
            scale=scale if scale > 1 else None, mesh=self.auto_mesh(conf),
            device=self.device)
        if conf.get("stream.chunk.rows"):
            if enc is None:
                raise ConfigError(
                    "stream.chunk.rows on MarkovStateTransitionModel "
                    "requires model.states (a chunked stream cannot "
                    "discover a stable state vocabulary)")
            model = _fit_streaming(
                self, conf, input_path, counters,
                lambda chunks, acc: chain.fit_chunks(
                    chunks, enc, accumulator=acc)[0], delim, skip)
        else:
            seqs = _sequences(input_path, delim, skip)
            model, enc = chain.fit(seqs, encoder=enc)
            counters.set("Records", "Processed", len(seqs))
        if model is not None and self.is_output_writer():
            write_output(output_path, model.to_lines(delim=conf.field_delim))


class HiddenMarkovModelBuilder(Job):
    """Supervised HMM estimation.  Fully tagged mode: tokens are
    ``obs<sub>state``; partially tagged mode (``partially.tagged=true``):
    state names inline, the observations around each attributed by the
    ``window.function`` weights (HiddenMarkovModelBuilder.java:136-260)."""

    name = "HiddenMarkovModelBuilder"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        delim = conf.field_delim_regex
        sub = conf.get("sub.field.delim", ":")
        skip = conf.get_int("skip.field.count", 1)
        builder = mk.HMMBuilder(
            laplace=conf.get_float("laplace.smoothing", 1.0),
            mesh=self.auto_mesh(conf), device=self.device)
        states = conf.get_list("model.states")
        obs_vocab = conf.get_list("model.observations")
        obs_enc = mk.SequenceEncoder(obs_vocab) if obs_vocab else None
        partial = conf.get_bool("partially.tagged", False)
        if partial and not states:
            raise ConfigError("partially.tagged mode requires model.states")
        window = conf.get_float_list("window.function",
                                     [1.0, 0.75, 0.5, 0.25])
        tag = lambda seqs: [[tuple(t.split(sub, 1)) for t in seq]  # noqa: E731
                            for seq in seqs]
        if conf.get("stream.chunk.rows"):
            if not states or obs_enc is None:
                raise ConfigError(
                    "stream.chunk.rows on HiddenMarkovModelBuilder requires "
                    "model.states and model.observations (a chunked stream "
                    "cannot discover stable vocabularies)")
            st_enc = mk.SequenceEncoder(states)
            if partial:
                fit = lambda chunks, acc: builder.fit_partially_tagged_chunks(  # noqa: E731
                    chunks, states, obs_enc, window_function=window,
                    accumulator=acc)
            else:
                fit = lambda chunks, acc: builder.fit_tagged_chunks(  # noqa: E731
                    (tag(ck) for ck in chunks), st_enc, obs_enc,
                    accumulator=acc)
            model = _fit_streaming(self, conf, input_path, counters, fit,
                                   delim, skip)
        else:
            seqs = _sequences(input_path, delim, skip)
            if partial:
                model = builder.fit_partially_tagged(
                    seqs, states, window_function=window, obs_encoder=obs_enc)
            else:
                st_enc = mk.SequenceEncoder(states) if states else None
                model = builder.fit_tagged(tag(seqs), state_encoder=st_enc,
                                           obs_encoder=obs_enc)
            counters.set("Records", "Processed", len(seqs))
        if model is not None and self.is_output_writer():
            write_output(output_path, model.to_lines(delim=conf.field_delim))


class ViterbiStatePredictor(Job):
    """Decode rows of (id, obs...) to state paths; ``output.state.only``
    chooses the plain path or ``obs:state`` pairs
    (ViterbiStatePredictor.java:114-142)."""

    name = "ViterbiStatePredictor"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        delim = conf.field_delim_regex
        model_path = (conf.get("hmm.model.file.path")
                      or conf.get("model.file.path"))
        if not model_path:
            raise ConfigError("hmm.model.file.path not set")
        model = mk.HMMModel.from_lines(read_lines(model_path),
                                       delim=conf.field_delim)
        predictor = mk.ViterbiStatePredictor(
            model, pair_output=not conf.get_bool("output.state.only", True),
            delim=conf.field_delim, mesh=self.auto_mesh(conf),
            device=self.device)
        skip = conf.get_int("skip.field.count", 1)
        rows = [[conf.field_delim.join(r[:skip])] + list(r[skip:])
                for r in _seq_rows(input_path, delim)]
        write_output(output_path, predictor.predict_lines(rows))
        counters.set("Records", "Processed", len(rows))

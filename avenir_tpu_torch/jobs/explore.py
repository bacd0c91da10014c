"""The exploration jobs — MutualInformation, CramerCorrelation,
HeterogeneityReductionCorrelation and the class samplers BaggingSampler
and UnderSamplingBalancer (explore/MutualInformation.java,
CramerCorrelation.java, HeterogeneityReductionCorrelation.java,
BaggingSampler.java, UnderSamplingBalancer.java); port of
``avenir_tpu/jobs/explore.py``, in one process."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.jobs.base import Job, read_lines, write_output
from avenir_tpu_torch.models import correlation as corr
from avenir_tpu_torch.models import mutual_info as mi
from avenir_tpu_torch.models import samplers
from avenir_tpu_torch.utils import prng
from avenir_tpu_torch.utils.metrics import Counters


def mi_output_lines(conf: JobConfig, result, names: List[str]) -> List[str]:
    """The MutualInformation job's output lines from a finished result."""
    delim = conf.field_delim
    lines: List[str] = []
    if conf.get_bool("output.mutual.info", True):
        lines.extend(result.to_lines(delim=delim))
    for algo in conf.get_list("mutual.info.score.algorithms", ["mim"]):
        kwargs = {}
        if algo == "mifs":
            kwargs["redundancy_factor"] = conf.get_float(
                "mutual.info.redundancy.factor", 1.0)
        ranked = mi.score_features(result, algo, **kwargs)
        lines.append(f"featureScore:{algo}")
        lines.extend(
            delim.join([names[f], f"{score:.6f}"]) for f, score in ranked)
    return lines


def correlation_plan(conf: JobConfig, schema, enc):
    """(src_idx, dst_idx, against_class, names) of a correlation job's
    attribute selection, shared by the jobs and the SharedScan stage.
    ``source.attributes`` / ``dest.attributes`` are schema ordinals
    (CramerCorrelation.java:95-100), mapped to binned indices; a dest list
    of exactly the class ordinal selects against-class mode."""
    binned_ords = [f.ordinal for f in enc.binned_fields]
    names = [schema.field_by_ordinal(o).name for o in binned_ords]
    ord_to_idx = {o: i for i, o in enumerate(binned_ords)}
    src = conf.get_int_list("source.attributes")
    dst = conf.get_int_list("dest.attributes")
    class_ord = schema.class_field.ordinal if schema.class_field else None
    against_class = dst is not None and class_ord is not None and dst == [class_ord]
    src_idx = [ord_to_idx[o] for o in src] if src else None
    dst_idx = (None if against_class or dst is None
               else [ord_to_idx[o] for o in dst])
    return src_idx, dst_idx, against_class, names


class MutualInformation(Job):
    """One-pass distributions + MI + feature-selection scores: MI values,
    then one ranked feature subset per algorithm in
    ``mutual.info.score.algorithms`` (mim/mifs/jmi/disr/mrmr)."""

    name = "MutualInformation"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        schema = self.load_schema(conf)
        mesh = self.auto_mesh(conf)
        ckpt = self.stream_checkpointer(conf)
        # in a fleet: see BayesianDistribution.execute
        owner, acc, distributed = self.distributed_plan(conf, ckpt)
        enc, data, rows_fn = self.encoded_data_source(
            conf, input_path, counters, checkpointer=ckpt, mesh=mesh,
            owner=owner)
        names = [schema.field_by_ordinal(f.ordinal).name
                 for f in enc.binned_fields]
        fit = lambda d: mi.MutualInformation(  # noqa: E731
            mesh=mesh, device=self.device).fit(
                d, feature_names=names, accumulator=acc)
        merged: dict = {}
        if distributed:
            data = self.distributed_stream(data, acc, rows_fn, merged)
            result = self.distributed_fit(fit, data, acc, merged)
            if result is None:             # a non-writer that owned no chunk
                counters.set("Records", "Processed", merged["rows"])
                return
        else:
            result = fit(data)
        rows = merged["rows"] if distributed else rows_fn()
        if self.is_output_writer():
            write_output(output_path, mi_output_lines(conf, result, names))
        if ckpt:
            ckpt.finish()
        counters.set("Records", "Processed", rows)


class _CorrelationJob(Job):
    """A categorical correlation job: one contingency table per selected
    attribute pair, one statistic per table, one output line per pair."""

    algorithm = "cramerIndex"

    def _algorithm(self, conf: JobConfig) -> str:
        return self.algorithm

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        schema = self.load_schema(conf)
        mesh = self.auto_mesh(conf)
        ckpt = self.stream_checkpointer(conf)
        # in a fleet: see BayesianDistribution.execute (the reference ran
        # this Tool across N machines, CramerCorrelation.java:83); the
        # contingency counts are exact, so the merge is order-free
        owner, acc, distributed = self.distributed_plan(conf, ckpt)
        enc, data, rows_fn = self.encoded_data_source(
            conf, input_path, counters, checkpointer=ckpt, mesh=mesh,
            owner=owner)
        src_idx, dst_idx, against_class, names = correlation_plan(
            conf, schema, enc)
        job = corr.CategoricalCorrelation(
            algorithm=self._algorithm(conf), mesh=mesh, device=self.device)
        fit = lambda d: job.fit(  # noqa: E731
            d, src=src_idx, dst=dst_idx, against_class=against_class,
            feature_names=names, accumulator=acc)
        merged: dict = {}
        if distributed:
            data = self.distributed_stream(data, acc, rows_fn, merged)
            result = self.distributed_fit(fit, data, acc, merged)
        else:
            result = fit(data)
        rows = merged["rows"] if distributed else rows_fn()
        if result is not None and self.is_output_writer():
            write_output(output_path, result.to_lines(delim=conf.field_delim))
        if ckpt:
            ckpt.finish()
        counters.set("Records", "Processed", rows)


class CramerCorrelation(_CorrelationJob):
    name = "CramerCorrelation"
    algorithm = "cramerIndex"


class HeterogeneityReductionCorrelation(_CorrelationJob):
    name = "HeterogeneityReductionCorrelation"

    def _algorithm(self, conf: JobConfig) -> str:
        # the reference's values: concentration | uncertainty
        # (HeterogeneityReductionCorrelation.java:70-84)
        algo = conf.get("heterogeneity.algorithm", "concentration")
        return {"concentration": "concentrationCoeff",
                "uncertainty": "uncertaintyCoeff"}.get(algo, algo)


class BaggingSampler(Job):
    """Bootstrap sample with replacement (BaggingSampler.java:100-122):
    row-level resampling of the raw lines, ``batch.size`` lines at a time,
    each batch with the next key of the ``seed`` key's split chain.  The
    fields are never inspected, so nothing is parsed."""

    name = "BaggingSampler"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        lines = read_lines(input_path)
        batch = conf.get_int("batch.size", 10_000)
        key = prng.prng_key(conf.get_int("seed", 0))
        out: List[str] = []
        for s in range(0, len(lines), batch):
            chunk = lines[s:s + batch]
            key, sub = prng.split(key)
            out.extend(chunk[i] for i in samplers.bootstrap_indices(
                sub, len(chunk)))
        write_output(output_path, out)
        counters.set("Records", "Processed", len(lines))
        counters.set("Records", "Emitted", len(out))


class UnderSamplingBalancer(Job):
    """Majority-class undersampler (UnderSamplingBalancer.java:92-164): keep
    minority rows, thin the others to p = minCount / classCount.  Only the
    class field of each raw line is read, so data the other jobs would
    reject (sentinels in numeric columns, class values outside a declared
    cardinality) samples as the reference's mapper sampled it.  The
    keep-mask compare runs on the job's device."""

    name = "UnderSamplingBalancer"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        schema = self.load_schema(conf)
        if schema.class_field is None:
            raise ValueError("undersampling requires a class attribute")
        class_ord = schema.class_field.ordinal
        delim = conf.field_delim_regex
        lines = read_lines(input_path)
        labels_raw = [ln.split(delim)[class_ord] for ln in lines]
        _values, inverse, cts = np.unique(
            np.asarray(labels_raw, dtype=object).astype(str),
            return_inverse=True, return_counts=True)
        labels = torch.from_numpy(inverse.astype(np.int32)).to(self.device)
        mask = samplers.undersample_mask(
            prng.prng_key(conf.get_int("seed", 0)), labels,
            cts.astype(np.float32))
        out = [lines[i] for i in np.flatnonzero(mask.cpu().numpy())]
        write_output(output_path, out)
        counters.set("Records", "Processed", len(lines))
        counters.set("Records", "Emitted", len(out))

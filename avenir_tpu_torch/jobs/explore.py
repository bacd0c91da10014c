"""The MutualInformation job (explore/MutualInformation.java); port of its
part of ``avenir_tpu/jobs/explore.py``."""

from __future__ import annotations

from typing import List

from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.jobs.base import (Job, refuse_stream_checkpoint,
                                        write_output)
from avenir_tpu_torch.models import mutual_info as mi
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


class MutualInformation(Job):
    """One-pass distributions + MI + feature-selection scores: MI values,
    then one ranked feature subset per algorithm in
    ``mutual.info.score.algorithms`` (mim/mifs/jmi/disr/mrmr)."""

    name = "MutualInformation"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        refuse_stream_checkpoint(conf, self.name)
        schema = self.load_schema(conf)
        enc, data, rows_fn = self.encoded_data_source(conf, input_path, counters)
        names = [schema.field_by_ordinal(f.ordinal).name
                 for f in enc.binned_fields]
        result = mi.MutualInformation(device=self.device).fit(
            data, feature_names=names)
        write_output(output_path, mi_output_lines(conf, result, names))
        counters.set("Records", "Processed", rows_fn())

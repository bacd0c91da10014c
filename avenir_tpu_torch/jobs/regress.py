"""The FisherDiscriminant job (discriminant/FisherDiscriminant.java); port
of its part of ``avenir_tpu/jobs/regress.py``."""

from __future__ import annotations

from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.jobs.base import Job, write_output
from avenir_tpu_torch.models import fisher as mfisher
from avenir_tpu_torch.utils.metrics import Counters


class FisherDiscriminant(Job):
    """Per-attribute univariate Fisher/LDA for a binary class: one line per
    continuous attribute with its pooled variance, the log-odds prior and
    the decision boundary (FisherDiscriminant.java:83-117)."""

    name = "FisherDiscriminant"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        _enc, ds, _rows = self.encode_input(conf, input_path, need_rows=False)
        schema = self.load_schema(conf)
        names = [schema.field_by_ordinal(o).name for o in ds.cont_ordinals]
        model = mfisher.FisherDiscriminant(device=self.device).fit(ds)
        write_output(output_path,
                     model.to_lines(feature_names=names, delim=conf.field_delim))
        counters.set("Records", "Processed", ds.num_rows)

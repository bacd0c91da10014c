"""Word-count job (text/WordCounter.java): text field by ordinal or the whole
line (:101-107), analyzer tokenization (:117-128), word,count rows out; port
of ``avenir_tpu/jobs/text.py``, counting on the job's device."""

from __future__ import annotations

from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.jobs.base import Job, input_files, write_output
from avenir_tpu_torch.text.wordcount import WordCount
from avenir_tpu_torch.utils.metrics import Counters


class WordCounter(Job):
    name = "WordCounter"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        ordinal = conf.get_int("text.field.ordinal", -1)
        delim = conf.field_delim_regex
        wc = WordCount(stopwords=conf.get_bool("remove.stop.words", True),
                       stem=conf.get_bool("stem.words", False),
                       device=self.device)
        n = 0
        for f in input_files(input_path):
            with open(f) as fh:
                lines = []
                for line in fh:
                    line = line.rstrip("\n")
                    if not line:
                        continue
                    n += 1
                    if ordinal >= 0:
                        parts = line.split(delim)
                        lines.append(parts[ordinal] if ordinal < len(parts) else "")
                    else:
                        lines.append(line)
                wc.add_lines(lines)
        write_output(output_path, wc.to_lines(delim=conf.field_delim))
        counters.set("Records", "Processed", n)
        counters.set("Words", "Distinct", len(wc.vocab))

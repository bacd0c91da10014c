"""Decision-tree jobs — port of ``avenir_tpu/jobs/tree.py``.

- :class:`ClassPartitionGenerator` emits scored candidate splits for one
  node level (the reference's split-file contract,
  explore/ClassPartitionGenerator.java), or with ``at.root`` only the
  dataset-level info content;
- :class:`SplitGenerator` is the same job under the reference's
  ``project.base.path``/``split.path`` directory convention;
- :class:`DataPartitioner` applies the best split and writes
  ``split=<attr>/segment=<i>/data/partition.txt`` directories
  (tree/DataPartitioner.java's on-disk layout);
- :class:`DecisionTreeBuilder` grows the whole tree in one job
  (``models/tree.py``) and writes it as a JSON model line plus the fitted
  encoder's state line; with ``tree.model.file.path`` it scores rows with
  a saved model instead.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np
import torch

from avenir_tpu_torch.core.config import ConfigError, JobConfig
from avenir_tpu_torch.jobs.base import Job, read_lines, write_output
from avenir_tpu_torch.models import tree as dtree
from avenir_tpu_torch.ops import hist
from avenir_tpu_torch.ops import info as oinfo
from avenir_tpu_torch.utils.metrics import ConfusionMatrix, Counters


def _tree_params(conf: JobConfig) -> dict:
    return dict(
        algorithm=conf.get("split.algorithm", "entropy"),
        max_split=conf.get_int("max.cat.attr.split.groups",
                               conf.get_int("max.split", 3)),
        attr_strategy={"userSpecified": "userSpecified", "all": "all",
                       "random": "randomK"}.get(
            conf.get("split.attribute.selection.strategy", "all"), "all"),
        user_attrs=conf.get_int_list("split.attributes"),
        random_k=conf.get_int("random.split.set.size"),
        top_n=conf.get_int("num.top.splits", 1),
        # split.selection.path device|host: where per-level split scoring
        # runs; split.search exhaustive|binary: the candidate family;
        # tree.hist.mode direct|cumsum|subtract: the level-table strategy;
        # tree.level.packed auto|on|off: disjoint-pack level tables
        selection=conf.get("split.selection.path", "device"),
        split_search=conf.get("split.search", "exhaustive"),
        hist_mode=conf.get("tree.hist.mode", "direct"),
        level_packed=conf.get("tree.level.packed", "auto"),
    )


def _is_categorical(job: Job, conf: JobConfig, ds) -> List[bool]:
    schema = job.load_schema(conf)
    return [schema.field_by_ordinal(o).is_categorical
            for o in ds.binned_ordinals]


class ClassPartitionGenerator(Job):
    """One-level candidate-split scoring: emits
    ``attr;splitKey;stat[;segment class distributions]`` rows, the contract
    DataPartitioner consumes (ClassPartitionGenerator.java:513-566)."""

    name = "ClassPartitionGenerator"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        _enc, ds, _rows = self.encode_input(conf, input_path, need_rows=False)
        p = _tree_params(conf)
        dev = self.device
        labels = torch.from_numpy(np.ascontiguousarray(ds.labels)).to(dev)
        if conf.get_bool("at.root"):
            # phase-1 bootstrap of the reference's two-job tree runbook:
            # only the dataset-level info content
            # (ClassPartitionGenerator.java:206-209,516-519)
            counts = torch.bincount(labels.long(), minlength=ds.num_classes
                                    ).to(torch.float32)
            stat_fn = (oinfo.entropy_from_counts if p["algorithm"] == "entropy"
                       else oinfo.gini_from_counts)
            write_output(output_path, [f"{float(stat_fn(counts)):.6f}"])
            counters.set("Records", "Processed", ds.num_rows)
            return
        all_splits = dtree.candidate_splits_for(
            ds, p["split_search"], p["max_split"],
            _is_categorical(self, conf, ds))
        # the reference's externally supplied parent info content (from the
        # at.root bootstrap); unset = derive from the node itself
        parent_info = conf.get_float("parent.info")
        codes = torch.from_numpy(np.ascontiguousarray(ds.codes)).to(dev)
        node_ids = torch.zeros(ds.num_rows, dtype=torch.int32, device=dev)
        # ONE count for the whole job: the [F, B, 1, C] table, on the same
        # routes DecisionTree.fit takes per level
        if dev.type == "cuda" and hist.cross_applicable(
                ds.num_binned, ds.max_bins, ds.num_classes):
            table_dev = dtree._level_table_cross(
                codes.t().contiguous(), node_ids, labels, 1, ds.num_classes,
                ds.max_bins)
        else:
            table_dev = dtree.node_bin_class_counts(
                codes, node_ids, labels, 1, ds.num_classes, ds.max_bins)
        out_distr = conf.get_bool("output.split.prob", False)
        split_chunk = conf.get_int("split.chunk", 128)

        def emit_row(sp, score, hh) -> str:
            row = [str(ds.binned_ordinals[sp.attr]), sp.key,
                   f"{float(score):.6f}"]
            if out_distr:                                 # hh: [G, C]
                tot = np.maximum(hh.sum(-1, keepdims=True), 1e-9)
                for g in range(sp.num_segments):
                    row.append(":".join(
                        f"{v:.4f}" for v in (hh[g] / tot[g])))
            return ";".join(row)

        lines: List[str] = []
        flat = (dtree.flatten_splits(all_splits, ds.max_bins, split_chunk,
                                     device=dev)
                if p["selection"] == "device" else None)
        if flat is not None and flat.num_real:
            # every candidate's histogram and score against the table on
            # the device; the fetch is the [S, 1] score sheet (plus the small
            # histograms only when the distribution columns are asked for)
            binary = p["hist_mode"] != "direct" and flat.all_binary
            scores, hh = dtree._device_score_all(
                table_dev, flat.seg_tab_dev, flat.attr_dev, flat.nseg_dev,
                parent_info, flat.thr_dev if binary else None,
                algorithm=p["algorithm"], gmax=flat.gmax, chunk=flat.chunk,
                want_hist=out_distr, binary=binary)
            scores = scores.cpu().numpy()
            hh = hh.cpu().numpy() if out_distr else None
            lines = [emit_row(sp, scores[si, 0],
                              hh[si, :, 0, :] if out_distr else None)
                     for si, sp in enumerate(flat.splits)]
        else:
            table = table_dev.cpu().numpy()
            for _a, chunk, scores, h in dtree.iter_scored_splits(
                    table, all_splits, p["algorithm"], split_chunk,
                    parent_info=parent_info):
                lines.extend(emit_row(sp, scores[si, 0], h[si, :, 0, :])
                             for si, sp in enumerate(chunk))
        write_output(output_path, lines)
        counters.set("Records", "Processed", ds.num_rows)
        counters.set("Splits", "Evaluated", len(lines))


class SplitGenerator(ClassPartitionGenerator):
    """Path-convention subclass (tree/SplitGenerator.java:39-54): reads
    ``project.base.path``/``split.path`` to derive in/out dirs; writes the
    candidate-splits file to the sibling ``splits`` dir."""

    name = "SplitGenerator"

    def run(self, conf: JobConfig, input_path: str = "", output_path: str = "",
            device=None) -> Counters:
        base = conf.get("project.base.path", "")
        rel = conf.get("split.path", "")
        inp = input_path or os.path.join(base, rel, "data")
        out = output_path or os.path.join(base, rel, "splits")
        return super().run(conf, inp, out, device=device)


class DataPartitioner(Job):
    """Apply the best candidate split: reads the splits file
    (``split.file.path`` or ``<input>/../splits``), selects best or
    random-from-top-N (DataPartitioner.java:157-201), and writes each
    record into ``split=<attr>/segment=<seg>/data/partition.txt`` under the
    output dir (:114-129).  Host work only."""

    name = "DataPartitioner"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        splits_path = conf.get("split.file.path") or os.path.join(
            os.path.dirname(input_path.rstrip(os.sep)), "splits")
        rows_split = [ln.split(";") for ln in read_lines(splits_path)
                      if not ln.startswith("featureScore")]
        scored = sorted(((float(r[2]), int(r[0]), r[1]) for r in rows_split),
                        reverse=True)
        top_n = conf.get_int("num.top.splits", 1)
        strategy = conf.get("split.selection.strategy", "best")
        rng = np.random.default_rng(conf.get_int("seed", 0))
        pick = scored[0] if strategy == "best" or top_n <= 1 else \
            scored[int(rng.integers(min(top_n, len(scored))))]
        _score, attr_ord, key = pick

        _enc, ds, lines = self.encode_input_with_lines(conf, input_path)
        a = ds.binned_ordinals.index(attr_ord)
        p = _tree_params(conf)
        all_splits = dtree.candidate_splits_for(
            ds, p["split_search"], p["max_split"],
            _is_categorical(self, conf, ds), attrs=[a])
        sp = next((s for s in all_splits[a] if s.key == key), None)
        if sp is None:
            raise ValueError(f"split key {key!r} not found for attribute {attr_ord}")
        segs = sp.seg_of_bin[ds.codes[:, a]]
        for g in range(sp.num_segments):
            seg_dir = os.path.join(output_path, f"split={attr_ord}",
                                   f"segment={g}", "data")
            os.makedirs(seg_dir, exist_ok=True)
            with open(os.path.join(seg_dir, "partition.txt"), "w") as fh:
                for i in np.nonzero(segs == g)[0]:
                    fh.write(lines[i])
                    fh.write("\n")
        counters.set("Records", "Processed", ds.num_rows)
        counters.set("Splits", "Segments", int(sp.num_segments))


class DecisionTreeBuilder(Job):
    """Whole-tree induction in one job.  Output: the tree as a JSON model
    line plus a fitted-encoder-state line (the tree's ``seg_of_bin`` tables
    are keyed by raw train-time bin codes, so scoring must reuse the
    train-time code space); validation mode adds confusion counters and
    ``tree.hist.phase.stats`` the per-level ``TreePhase`` walls."""

    name = "DecisionTreeBuilder"

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        if conf.get("tree.model.file.path"):
            self._predict(conf, input_path, output_path, counters)
            return
        enc, ds, _rows = self.encode_input(conf, input_path, need_rows=False)
        p = _tree_params(conf)
        trainer = dtree.DecisionTree(
            algorithm=p["algorithm"], max_split=p["max_split"],
            attr_strategy=p["attr_strategy"], user_attrs=p["user_attrs"],
            random_k=p["random_k"], top_n=p["top_n"],
            max_depth=conf.get_int("max.depth", 4),
            min_node_size=conf.get_int("min.node.size", 32),
            seed=conf.get_int("seed", 0),
            selection=p["selection"], split_search=p["split_search"],
            hist_mode=p["hist_mode"], level_packed=p["level_packed"],
            collect_phase_stats=conf.get_bool("tree.hist.phase.stats", False),
            device=self.device,
        )
        model = trainer.fit(ds, _is_categorical(self, conf, ds))
        for st in trainer.level_stats:
            lv = st["level"]
            counters.set("TreePhase", f"level.{lv}.table.us",
                         int(st["table_ms"] * 1e3))
            counters.set("TreePhase", f"level.{lv}.select.us",
                         int(st["select_ms"] * 1e3))
            counters.set("TreePhase", f"level.{lv}.partition.us",
                         int(st["partition_ms"] * 1e3))
        write_output(output_path, [model.to_string(),
                                   json.dumps({"encoder": enc.state_dict()})])
        if conf.get("prediction.mode") == "validation":
            _pred, _distr, _cm, c2 = trainer.predict(
                model, ds, validate=True,
                pos_class=conf.get("positive.class.value"))
            counters.merge(c2)
        counters.set("Records", "Processed", ds.num_rows)
        counters.set("Tree", "Nodes", len(model.nodes))

    def _predict(self, conf: JobConfig, input_path: str, output_path: str,
                 counters: Counters) -> None:
        """Score new rows with a saved JSON tree model
        (``tree.model.file.path``), appending the predicted class.  The
        model file's second line carries the fitted encoder state, restored
        here so codes (and label indices, in validation mode) live in the
        train-time space."""
        model_lines = read_lines(conf.get("tree.model.file.path"))
        model = dtree.DecisionTreeModel.from_string(model_lines[0])
        enc = self.encoder_for(conf)
        if len(model_lines) > 1:
            enc.load_state_dict(json.loads(model_lines[1])["encoder"])
        else:
            # never re-fit on the scoring input: codes would shift whenever
            # its value range/vocabulary differs from training
            missing = [f.name for f in enc.binned_fields
                       if f.ordinal not in enc.vocab
                       and f.ordinal not in enc.bin_offset]
            if missing or not enc.class_values:
                raise ValueError(
                    "tree model file has no encoder-state line and the schema "
                    f"does not fully specify the encoding (missing: {missing}"
                    f"{'' if enc.class_values else ', class cardinality'}); "
                    "re-train with this version to embed encoder state")
            enc._fitted = True
        validation = conf.get("prediction.mode") == "validation"
        _enc, ds, rows = self.encode_input(conf, input_path,
                                           with_labels=validation,
                                           encoder=enc)
        if validation and ds.labels is None:
            raise ConfigError("prediction.mode=validation requires labeled "
                              "input (class column missing)")
        walk = dtree.predict_fn(model, device=self.device)
        pred, _distr = walk(torch.from_numpy(
            np.ascontiguousarray(ds.codes)).to(self.device))
        pred = pred.cpu().numpy()
        delim = conf.field_delim
        lines = [delim.join(list(r) + [model.class_values[int(p)]])
                 for r, p in zip(rows, pred)]
        write_output(output_path, lines)
        if validation:
            cm = ConfusionMatrix(model.class_values,
                                 pos_class=conf.get("positive.class.value"))
            cm.add_batch(ds.labels, pred)
            cm.publish(counters)
        counters.set("Records", "Processed", ds.num_rows)

"""Record encoding — CSV string fields → fixed-shape integer/float arrays.

This is the rebuild's single most reused kernel. The reference re-implements
the same per-record binning in every mapper (categorical bin = the value
string, numeric bin = ``int(value / bucketWidth)`` — reference
bayesian/BayesianDistribution.java:149-160, explore/MutualInformation.java:150-190);
here it is done once, producing dense int codes that every downstream
aggregation consumes as one-hot counts.

Key differences from the reference, forced by the fixed-shape count kernels:

- The reference's hashmap keyed by value-string gives it an *open* vocabulary
  for free. Fixed-width count tables need a *closed* vocabulary, so :meth:`DatasetEncoder.fit`
  builds one (schema ``cardinality`` when present, observed values otherwise)
  and every categorical feature reserves one out-of-vocabulary bin at index
  ``n_bins - 1`` so transform never fails on unseen values.
- Numeric binned features get a ``bin_offset`` so codes are 0-based even for
  negative values (the reference's Java int division truncates toward zero;
  we use floor and carry the offset, which only relabels bins — all
  count-based statistics are invariant to bin labels).

Encoded output is column-major:

- ``codes``  int32 [N, Fb] — bin index per *binned* feature (categorical or
  bucketWidth numeric), in schema ordinal order;
- ``cont``   float32 [N, Fc] — raw value per *continuous* (Gaussian) feature;
- ``labels`` int32 [N] — class-value index (when a class attribute exists);
- ``ids``    object [N] — untouched id strings for output joining.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, Iterator, List, Optional

import numpy as np

from avenir_tpu_torch.core.config import ConfigError
from avenir_tpu_torch.core.csv_io import iter_csv_chunks
from avenir_tpu_torch.core.schema import FeatureField, FeatureSchema

OOV = "__OOV__"


class NoDataError(ValueError):
    """Raised when a fit stream yields zero chunks."""


@dataclass
class EncodedDataset:
    """A fully-encoded batch (or whole dataset) ready for device transfer.

    ``codes``, ``cont`` and ``labels`` are numpy arrays, or torch tensors
    once ``runtime/feeder.py`` has staged the chunk on the device."""

    codes: np.ndarray                       # int32 [N, Fb]
    cont: np.ndarray                        # float32 [N, Fc]
    labels: Optional[np.ndarray] = None     # int32 [N]
    ids: Optional[np.ndarray] = None        # object [N]
    n_bins: np.ndarray = dc_field(default_factory=lambda: np.zeros(0, np.int32))  # [Fb]
    class_values: List[str] = dc_field(default_factory=list)
    binned_ordinals: List[int] = dc_field(default_factory=list)
    cont_ordinals: List[int] = dc_field(default_factory=list)
    # the true (pre-ballast) row count of a padded batch; None when
    # num_rows is the truth.  Row accounting reads this, never the pad.
    valid_rows: Optional[int] = None

    @property
    def num_rows(self) -> int:
        return int(self.codes.shape[0] or self.cont.shape[0])

    @property
    def num_binned(self) -> int:
        return int(self.codes.shape[1])

    @property
    def num_cont(self) -> int:
        return int(self.cont.shape[1])

    @property
    def num_classes(self) -> int:
        return len(self.class_values)

    @property
    def max_bins(self) -> int:
        return int(self.n_bins.max()) if self.n_bins.size else 0

    def bin_mask(self) -> np.ndarray:
        """bool [Fb, B] — True where a bin index is valid for the feature."""
        b = self.max_bins
        return np.arange(b)[None, :] < self.n_bins[:, None]

    def slice(self, start: int, stop: int) -> "EncodedDataset":
        return EncodedDataset(
            codes=self.codes[start:stop],
            cont=self.cont[start:stop],
            labels=None if self.labels is None else self.labels[start:stop],
            ids=None if self.ids is None else self.ids[start:stop],
            n_bins=self.n_bins,
            class_values=self.class_values,
            binned_ordinals=self.binned_ordinals,
            cont_ordinals=self.cont_ordinals,
        )


def pad_rows(n_target: int, *arrays: Optional[np.ndarray], fill: int = -1):
    """Pad axis 0 of each array up to ``n_target`` rows, the one ballast
    fill of the package (the JAX package's ``pad_rows``): integer arrays
    pad with ``fill`` (−1 by default, dropped by every count table under
    the drop-invalid contract), float arrays with 0 (the moments pair them
    with label −1 rows, so they drop out too).  None entries pass through;
    a single array comes back bare."""
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        pad = n_target - a.shape[0]
        if pad < 0:
            raise ValueError(f"n_target {n_target} < batch {a.shape[0]}")
        if pad == 0:
            out.append(a)
            continue
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        val = fill if np.issubdtype(a.dtype, np.integer) else 0
        out.append(np.pad(a, widths, constant_values=val))
    return out if len(out) > 1 else out[0]


def pad_ballast(ds: EncodedDataset, n_target: int,
                fill: int = -1) -> EncodedDataset:
    """Pad the batch axis with ballast rows up to ``n_target``, as the JAX
    package's ``pad_ballast``: integer codes take ``fill`` (−1 by default:
    dropped by every count table, the drop-invalid contract), floats 0,
    labels always −1.  Scoring callers that slice their outputs back to the
    real rows pass ``fill=0`` so a pad row stays in the vocabulary.  The
    result records the true row count in ``valid_rows``."""
    if ds.num_rows == n_target:
        return ds
    codes, cont = pad_rows(n_target, ds.codes, ds.cont, fill=fill)
    labels = (None if ds.labels is None
              else pad_rows(n_target, ds.labels, fill=-1))
    return EncodedDataset(
        codes=codes, cont=cont, labels=labels, ids=None,
        n_bins=ds.n_bins, class_values=ds.class_values,
        binned_ordinals=ds.binned_ordinals, cont_ordinals=ds.cont_ordinals,
        valid_rows=(ds.valid_rows if ds.valid_rows is not None
                    else ds.num_rows))


def peek_chunks(data):
    """(meta, lazy chunk iterable) for the Union[EncodedDataset,
    Iterable[EncodedDataset]] fit contract: peek the first chunk for shape
    metadata without materializing the stream; raises on empty input."""
    import itertools

    it = iter([data] if isinstance(data, EncodedDataset) else data)
    meta = next(it, None)
    if meta is None:
        raise NoDataError("no data")
    return meta, itertools.chain([meta], it)


class DatasetEncoder:
    """Schema-driven encoder with a fitted closed vocabulary.

    Usage::

        enc = DatasetEncoder(schema)
        ds = enc.fit_transform(rows)          # rows: object array [N, ncols]
        more = enc.transform(other_rows)      # same vocab/binning
    """

    def __init__(self, schema: FeatureSchema):
        self.schema = schema
        self.binned_fields: List[FeatureField] = schema.binned_feature_fields
        self.cont_fields: List[FeatureField] = schema.continuous_feature_fields
        self.class_field: Optional[FeatureField] = schema.class_field
        self.id_field: Optional[FeatureField] = schema.id_field
        # per-binned-feature state
        self.vocab: Dict[int, Dict[str, int]] = {}       # ordinal -> value -> code (categorical)
        self.bin_offset: Dict[int, int] = {}             # ordinal -> min bin (numeric binned)
        self.n_bins: Dict[int, int] = {}                 # ordinal -> bin count (incl. OOV slot for categorical)
        self.class_values: List[str] = []
        self.class_map: Dict[str, int] = {}
        self._inv_vocab_cache: Dict[int, Dict[int, str]] = {}
        self._fitted = False
        # pre-seed from schema where the schema fully specifies the vocabulary
        for f in self.binned_fields:
            if f.is_categorical and f.cardinality:
                self.vocab[f.ordinal] = {v: i for i, v in enumerate(f.cardinality)}
                self.n_bins[f.ordinal] = len(f.cardinality) + 1  # + OOV
            elif not f.is_categorical and f.min is not None and f.max is not None:
                if not f.bucket_width:
                    raise ConfigError(f"field {f.name!r}: bucketWidth must be "
                                      f"non-zero")
                lo = int(np.floor(f.min / f.bucket_width))
                hi = int(np.floor(f.max / f.bucket_width))
                self.bin_offset[f.ordinal] = lo
                self.n_bins[f.ordinal] = hi - lo + 1
        if self.class_field is not None and self.class_field.cardinality:
            self.class_values = list(self.class_field.cardinality)
            self.class_map = {v: i for i, v in enumerate(self.class_values)}

    def max_ordinal(self, with_labels: bool = True) -> int:
        """Largest CSV column ordinal any consumed field reads; a row must
        have more columns than this."""
        ords = [f.ordinal for f in self.binned_fields + self.cont_fields]
        if self.id_field is not None:
            ords.append(self.id_field.ordinal)
        if with_labels and self.class_field is not None:
            ords.append(self.class_field.ordinal)
        return max(ords, default=-1)

    def schema_complete(self, with_labels: bool = True) -> bool:
        """True when the schema declares every vocabulary and bin range (and
        the class values, if ``with_labels``), so :meth:`transform` needs no
        fitting pass — the reference mappers' contract, and the native
        encoder's condition."""
        for f in self.binned_fields:
            if f.ordinal not in self.vocab and f.ordinal not in self.bin_offset:
                return False
        if with_labels and self.class_field is not None and not self.class_values:
            return False
        return True

    # -- fitting -------------------------------------------------------------
    def fit(self, rows: np.ndarray) -> "DatasetEncoder":
        """Learn vocabularies / bin ranges not fully specified by the schema."""
        for f in self.binned_fields:
            col = rows[:, f.ordinal]
            if f.is_categorical:
                if f.ordinal not in self.vocab:
                    # a numpy column of CSV strings: host data, no tensor to sync
                    # graftlint: disable=GL005
                    values = sorted(set(col.tolist()))
                    self.vocab[f.ordinal] = {v: i for i, v in enumerate(values)}
                    self.n_bins[f.ordinal] = len(values) + 1  # + OOV
            else:
                if f.ordinal not in self.bin_offset:
                    vals = col.astype(np.float64)
                    bins = np.floor(vals / f.bucket_width).astype(np.int64)
                    lo, hi = int(bins.min()), int(bins.max())
                    self.bin_offset[f.ordinal] = lo
                    self.n_bins[f.ordinal] = hi - lo + 1
        if self.class_field is not None and not self.class_values:
            col = rows[:, self.class_field.ordinal]
            self.class_values = sorted(set(col.tolist()))
            self.class_map = {v: i for i, v in enumerate(self.class_values)}
        self._fitted = True
        return self

    # -- transform -----------------------------------------------------------
    def transform(self, rows: np.ndarray, with_labels: bool = True) -> EncodedDataset:
        if not self._fitted:
            # schema may have fully specified everything; verify
            missing = [f.name for f in self.binned_fields
                       if f.ordinal not in self.vocab and f.ordinal not in self.bin_offset]
            if missing or (self.class_field is not None and with_labels and not self.class_values):
                raise ConfigError(
                    f"encoder not fitted and schema incomplete for fields: {missing}")
        n = rows.shape[0]
        codes = np.zeros((n, len(self.binned_fields)), dtype=np.int32)
        for j, f in enumerate(self.binned_fields):
            col = rows[:, f.ordinal]
            if f.is_categorical:
                vmap = self.vocab[f.ordinal]
                oov = self.n_bins[f.ordinal] - 1
                # a numpy column of CSV strings: host data, no tensor to sync
                # graftlint: disable=GL005
                codes[:, j] = np.array([vmap.get(v, oov) for v in col.tolist()], dtype=np.int32)
            else:
                vals = col.astype(np.float64)
                bins = np.floor(vals / f.bucket_width).astype(np.int64) - self.bin_offset[f.ordinal]
                codes[:, j] = np.clip(bins, 0, self.n_bins[f.ordinal] - 1).astype(np.int32)
        cont = np.zeros((n, len(self.cont_fields)), dtype=np.float32)
        for j, f in enumerate(self.cont_fields):
            cont[:, j] = rows[:, f.ordinal].astype(np.float64).astype(np.float32)
        labels = None
        if self.class_field is not None and with_labels and rows.shape[1] > self.class_field.ordinal:
            col = rows[:, self.class_field.ordinal]
            try:
                labels = np.array([self.class_map[v] for v in col.tolist()], dtype=np.int32)
            except KeyError as e:
                raise ValueError(f"unknown class value {e} (known: {self.class_values})") from None
        ids = rows[:, self.id_field.ordinal] if self.id_field is not None else None
        return EncodedDataset(
            codes=codes, cont=cont, labels=labels, ids=ids,
            n_bins=np.array([self.n_bins[f.ordinal] for f in self.binned_fields], dtype=np.int32),
            class_values=list(self.class_values),
            binned_ordinals=[f.ordinal for f in self.binned_fields],
            cont_ordinals=[f.ordinal for f in self.cont_fields],
        )

    def fit_transform(self, rows: np.ndarray, with_labels: bool = True) -> EncodedDataset:
        return self.fit(rows).transform(rows, with_labels=with_labels)

    # -- streaming -----------------------------------------------------------
    def iter_encoded(
        self, source, chunk_rows: int = 1_000_000, delim: str = ",", with_labels: bool = True,
    ) -> Iterator[EncodedDataset]:
        """Stream CSV chunks through :meth:`transform` (fit must have run,
        or the schema be complete)."""
        for chunk in iter_csv_chunks(source, chunk_rows=chunk_rows, delim=delim):
            yield self.transform(chunk, with_labels=with_labels)

    # -- state capture (ship the fitted encoding with a saved model) ---------
    def state_dict(self) -> Dict:
        """JSON-safe fitted state: vocabularies, bin offsets/counts, class
        values — the same dict the JAX package's encoder writes.  Saved next
        to models whose parameters are keyed by raw bin codes (the decision
        tree's ``seg_of_bin`` tables), so scoring re-creates the train-time
        code space instead of re-fitting on the scoring input."""
        return {
            "vocab": {str(k): v for k, v in self.vocab.items()},
            "bin_offset": {str(k): v for k, v in self.bin_offset.items()},
            "n_bins": {str(k): v for k, v in self.n_bins.items()},
            "class_values": list(self.class_values),
        }

    def load_state_dict(self, state: Dict) -> "DatasetEncoder":
        self.vocab = {int(k): dict(v) for k, v in state["vocab"].items()}
        self.bin_offset = {int(k): int(v) for k, v in state["bin_offset"].items()}
        self.n_bins = {int(k): int(v) for k, v in state["n_bins"].items()}
        self.class_values = list(state["class_values"])
        self.class_map = {v: i for i, v in enumerate(self.class_values)}
        self._inv_vocab_cache = {}
        self._fitted = True
        return self

    def _inverse_vocab(self, ordinal: int) -> Dict[int, str]:
        if ordinal not in self._inv_vocab_cache:
            self._inv_vocab_cache[ordinal] = {i: v for v, i in self.vocab[ordinal].items()}
        return self._inv_vocab_cache[ordinal]

    def bin_label(self, binned_index: int, code: int) -> str:
        """Human/serde label of a bin code, matching the reference's emitted bin
        labels (value string for categorical, integer bin id for numeric)."""
        f = self.binned_fields[binned_index]
        if f.is_categorical:
            return self._inverse_vocab(f.ordinal).get(code, OOV)
        return str(code + self.bin_offset[f.ordinal])

    def bin_code(self, binned_index: int, label: str) -> int:
        f = self.binned_fields[binned_index]
        if f.is_categorical:
            return self.vocab[f.ordinal].get(label, self.n_bins[f.ordinal] - 1)
        return int(label) - self.bin_offset[f.ordinal]

    def class_label(self, idx: int) -> str:
        return self.class_values[idx]

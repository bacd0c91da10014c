"""JSON feature schema — the dataset-semantics contract.

Parses the same JSON schema files the reference consumes (e.g.
``resource/churn.json``, ``resource/hosp_readmit.json``): a ``fields`` list
where each field carries ``name``, ``ordinal``, ``dataType``, and optional
``id`` / ``feature`` / ``classAttr`` flags, ``cardinality`` (categorical
vocabulary), ``bucketWidth`` (numeric binning) and ``min`` / ``max``; other keys are
ignored.

Field semantics mirror the subset of chombo ``FeatureSchema`` /
``FeatureField`` the reference actually uses (reference uses:
bayesian/BayesianDistribution.java:140-175, explore/ClassPartitionGenerator.java:235-272).
The class attribute is the field flagged ``classAttr`` or, failing that, the
unique field that is neither an id nor a feature (the convention in the
reference's shipped schemas, e.g. ``status`` in churn.json).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

CATEGORICAL = "categorical"
INT = "int"
LONG = "long"
DOUBLE = "double"
STRING = "string"

_NUMERIC_TYPES = (INT, LONG, DOUBLE)


@dataclass
class FeatureField:
    """One column of the CSV record, as described by the JSON schema."""

    name: str
    ordinal: int
    data_type: str = STRING
    is_id: bool = False
    is_feature: bool = False
    is_class_attr: bool = False
    cardinality: Optional[List[str]] = None
    bucket_width: Optional[float] = None
    min: Optional[float] = None
    max: Optional[float] = None

    @property
    def is_categorical(self) -> bool:
        return self.data_type == CATEGORICAL

    @property
    def is_numeric(self) -> bool:
        return self.data_type in _NUMERIC_TYPES

    @property
    def is_binned(self) -> bool:
        """True if values map to a discrete bin index.

        Categorical fields bin by vocabulary position; numeric fields bin by
        ``floor(value / bucketWidth)`` when ``bucketWidth`` is defined — the
        same binning rule the reference applies per record
        (bayesian/BayesianDistribution.java:149-160). Numeric fields without a
        bucket width are modeled as continuous (Gaussian).
        """
        return self.is_categorical or (self.is_numeric and self.bucket_width is not None)

    @property
    def is_continuous(self) -> bool:
        return self.is_numeric and self.bucket_width is None

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "FeatureField":
        card = obj.get("cardinality")
        if card is not None:
            card = [str(v) for v in card]
        return cls(
            name=str(obj.get("name", "")),
            ordinal=int(obj["ordinal"]),
            data_type=str(obj.get("dataType", STRING)),
            is_id=bool(obj.get("id", False)),
            is_feature=bool(obj.get("feature", False)),
            is_class_attr=bool(obj.get("classAttr", False)),
            cardinality=card,
            bucket_width=(float(obj["bucketWidth"]) if "bucketWidth" in obj else None),
            min=(float(obj["min"]) if "min" in obj else None),
            max=(float(obj["max"]) if "max" in obj else None),
        )


class FeatureSchema:
    """Ordered collection of :class:`FeatureField` with role accessors."""

    def __init__(self, fields: Sequence[FeatureField]):
        self.fields: List[FeatureField] = sorted(fields, key=lambda f: f.ordinal)
        self._by_ordinal = {f.ordinal: f for f in self.fields}

    # -- construction --------------------------------------------------------
    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "FeatureSchema":
        return cls([FeatureField.from_json(f) for f in obj.get("fields", [])])

    @classmethod
    def from_file(cls, path: str) -> "FeatureSchema":
        with open(path, "r") as fh:
            return cls.from_json(json.load(fh))

    # -- accessors -----------------------------------------------------------
    def field_by_ordinal(self, ordinal: int) -> FeatureField:
        return self._by_ordinal[ordinal]

    @property
    def id_field(self) -> Optional[FeatureField]:
        for f in self.fields:
            if f.is_id:
                return f
        return None

    @property
    def class_field(self) -> Optional[FeatureField]:
        for f in self.fields:
            if f.is_class_attr:
                return f
        rest = [f for f in self.fields if not f.is_id and not f.is_feature]
        if len(rest) == 1:
            return rest[0]
        return None

    @property
    def feature_fields(self) -> List[FeatureField]:
        return [f for f in self.fields if f.is_feature]

    @property
    def binned_feature_fields(self) -> List[FeatureField]:
        return [f for f in self.feature_fields if f.is_binned]

    @property
    def continuous_feature_fields(self) -> List[FeatureField]:
        return [f for f in self.feature_fields if f.is_continuous]

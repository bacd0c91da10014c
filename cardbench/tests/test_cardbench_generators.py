"""The generators' codes and floats are what the program's own encoder
gives on a CSV sample of the same rows."""

import io
import json
import os

import numpy as np
import torch

from cardbench.configs.elearn_knn import generator as elearn
from cardbench.configs.hosp_readmit import generator as hosp

HERE = os.path.dirname(os.path.abspath(__file__))


def _config(name):
    with open(os.path.join(HERE, "..", "configs", name, "config.json")) as fh:
        return json.load(fh)


def _encode(schema_json, rows):
    from avenir_tpu_torch.core.csv_io import read_csv_string
    from avenir_tpu_torch.core.encoding import DatasetEncoder
    from avenir_tpu_torch.core.schema import FeatureSchema

    text = io.StringIO()
    for row in rows:
        text.write(",".join(row) + "\n")
    enc = DatasetEncoder(FeatureSchema.from_json(schema_json))
    return enc, enc.transform(read_csv_string(text.getvalue()))


def test_hospital_codes_equal_the_encoders():
    schema = _config("hosp_readmit")["schema"]
    gen = torch.Generator().manual_seed(2**31 + 5)
    raw = hosp.raw_block(gen, 3000, "cpu")
    codes, labels = hosp.encode_block(raw, schema)
    enc, ds = _encode(schema, hosp.csv_rows(raw, schema, 3000))
    np.testing.assert_array_equal(codes.numpy(), ds.codes)
    np.testing.assert_array_equal(labels.numpy(), ds.labels)
    assert list(ds.n_bins) == hosp.n_bins(schema)
    assert list(ds.class_values) == hosp.class_values(schema)


def test_hospital_rows_follow_the_rules():
    schema = _config("hosp_readmit")["schema"]
    gen = torch.Generator().manual_seed(11)
    raw = hosp.raw_block(gen, 200_000, "cpu")
    age = raw["age"]
    assert int(age.min()) >= 10 and int(age.max()) <= 90
    assert 130 <= int(raw["weight"].min()) and int(raw["weight"].max()) <= 250
    # most of the over-68s are retired, and readmission is about 20% + bumps
    old = age > 68
    assert float((raw["employmentStatus"][old] == 2).float().mean()) > 0.8
    rate = float(raw["readmitted"].float().mean())
    assert 0.3 < rate < 0.5
    codes, _ = hosp.encode_block(raw, schema)
    assert (codes.max(dim=0).values < torch.tensor(hosp.n_bins(schema))).all()


def test_hospital_rows_depend_on_the_seed_alone():
    schema = _config("hosp_readmit")["schema"]
    a = hosp.generate(schema, 10_000, 2**31 + 17, "cpu", block=4096)
    b = hosp.generate(schema, 10_000, 2**31 + 17, "cpu", block=4096)
    c = hosp.generate(schema, 10_000, 2**31 + 18, "cpu", block=4096)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


def test_elearn_floats_equal_the_encoders():
    config = _config("elearn_knn")
    classes = [f for f in config["schema"]["fields"]
               if f["name"] == "status"][0]["cardinality"]
    x, y = elearn.generate(2000, 2**31 + 99, 0)
    _, ds = _encode(config["schema"], elearn.csv_rows(x, y, classes))
    np.testing.assert_array_equal(x, ds.cont)
    np.testing.assert_array_equal(y, ds.labels)
    assert ds.codes.shape == (2000, 0)


def test_elearn_streams_differ_and_repeat():
    a, _ = elearn.generate(100, 3, 0)
    b, _ = elearn.generate(100, 3, 0)
    c, _ = elearn.generate(100, 3, 1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)

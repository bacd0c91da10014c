"""The encoded stream's chunk read as one byte block and its device route,
on the CPU:

- ``jobs/base.py::BlockReader`` reads the lines ``_read_lines`` reads, at
  the same end offsets and with the same cursors, whatever the chunk size,
  the blank lines, the line ends or the chunk owners;
- the plain version of ``csrc/csv_encode.cu`` (``ops/csv.py``) equals the
  native encoder on generated rows and on hand-made fields it takes, and
  refuses the fields off its fast path, after which the chunk's native
  encode gives the native values or the native error;
- the NB + MI pipeline through the device route's decode (the plain
  version, on the CPU) writes the host route's part files, byte for byte.
"""

import copy
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from avenir_tpu_torch.core.config import JobConfig  # noqa: E402
from avenir_tpu_torch.core.encoding import DatasetEncoder  # noqa: E402
from avenir_tpu_torch.core.schema import FeatureSchema  # noqa: E402
from avenir_tpu_torch.datagen.elearn import (  # noqa: E402
    ELEARN_SCHEMA_JSON, generate_elearn)
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)
from avenir_tpu_torch.jobs import base  # noqa: E402
from avenir_tpu_torch.jobs.base import BlockReader, Job  # noqa: E402
from avenir_tpu_torch.ops import csv as tcsv  # noqa: E402
from avenir_tpu_torch.pipeline.driver import Pipeline  # noqa: E402
from avenir_tpu_torch.runtime import native  # noqa: E402
from avenir_tpu_torch.utils.metrics import Counters  # noqa: E402

LONG = b"x," * (3 * BlockReader.FIRST_READ // 2)      # past the first read
FILES = {
    "blank_inside_and_at_boundaries":
        b"a,1\n\n  \nb,2\n\t\x0b\x0c\nc,3\n \r\nd,4\n\ne,5\n",
    "trailing_blank_lines": b"a,1\nb,2\nc,3\n\n \n\t\n",
    "no_final_newline": b"a,1\nb,2\n\nc,3",
    "crlf": b"a,1\r\nb,2\r\n\r\nc,3\r\n",
    "blank_only": b"\n  \n\r\n",
    "empty": b"",
    "longer_than_the_first_read": b"a,1\n" + LONG + b"\nb,2\n\n" + LONG,
}


def _chunks(path, chunk_rows, read, lines=lambda raw: raw):
    """(end offset, non-blank lines, ``lines(payload)``) of each task, the
    read of nothing too; a block is valid until the next read."""
    out, off = [], 0
    while True:
        raw, n, end = read(path, off, chunk_rows, True)
        out.append((end, n, lines(raw) if n else None))
        if not n:
            return out
        off = end


def _block_lines(block):
    assert block.starts[-1] <= block.nbytes
    assert block.first_line() == block.lines()[0]
    return block.lines()


@pytest.mark.parametrize("chunk_rows", [1, 2, 7, 1_000_000])
@pytest.mark.parametrize("name", sorted(FILES))
def test_block_reader_reads_the_lines_of_read_lines(tmp_path, name,
                                                    chunk_rows):
    path = tmp_path / "part"
    path.write_bytes(FILES[name])
    want = _chunks(str(path), chunk_rows, base._read_line_chunk)
    got = _chunks(str(path), chunk_rows, BlockReader().read, _block_lines)
    assert got == want


@pytest.mark.parametrize("chunk_rows", [1, 2, 7, 1_000_000])
def test_block_reader_keeps_the_cursors_and_owners(tmp_path, chunk_rows):
    """The chunk engine over two files with either reader, an owner that
    refuses every other chunk: the same offsets, chunk indices and lines."""
    d = tmp_path / "in"
    d.mkdir()
    (d / "part-0").write_bytes(FILES["blank_inside_and_at_boundaries"])
    (d / "part-1").write_bytes(FILES["crlf"])
    conf = JobConfig()
    conf.set("stream.chunk.rows", str(chunk_rows))

    def run(read, decode):
        return [(f, off, i, p) for f, off, i, p in Job._iter_chunks_retrying(
            conf, str(d), Counters(), decode, owner=lambda i: i % 2 == 0,
            read=read)]

    want = run(None, lambda raw, path: raw)
    got = run(BlockReader().read, lambda block, path: block.lines())
    assert got == want and want


# -- the plain version of the kernel against the native encoder --------------

MIXED_SCHEMA_JSON = copy.deepcopy(HOSP_SCHEMA_JSON)
for _f in MIXED_SCHEMA_JSON["fields"][1:4]:
    for _k in ("bucketWidth", "min", "max"):
        _f.pop(_k)
SCHEMAS = {
    "hospital": (HOSP_SCHEMA_JSON, generate_hosp_readmit),
    "elearn": (ELEARN_SCHEMA_JSON, generate_elearn),
    "mixed": (MIXED_SCHEMA_JSON, generate_hosp_readmit),
}


def _block(tmp_path, data: bytes):
    path = tmp_path / "chunk.csv"
    path.write_bytes(data)
    block, rows, _ = BlockReader().read(str(path), 0, 1 << 30, True)
    assert rows
    return block


def _encoder(schema_json, rows):
    enc = DatasetEncoder(FeatureSchema.from_json(schema_json))
    return enc.fit(rows) if not enc.schema_complete(True) else enc


def _device_encode(block, enc, ncols, with_labels=True):
    return tcsv.encode_csv(torch.from_numpy(block.packed), block.rows,
                           block.data_off, block.nbytes,
                           tcsv.CsvSpec(enc, with_labels), ncols, ",", "cpu")


def _same(got, want):
    codes, labels, cont = got
    assert codes.dtype == torch.int32 and cont.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), want.codes)
    np.testing.assert_array_equal(cont.numpy().view(np.int32),
                                  want.cont.view(np.int32))
    if want.labels is None:
        assert labels is None
    else:
        np.testing.assert_array_equal(labels.numpy(), want.labels)


@pytest.mark.parametrize("with_labels", [True, False])
@pytest.mark.parametrize("eol", ["\n", "\r\n"])
@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_plain_encode_equals_native_on_generated_rows(tmp_path, name, eol,
                                                      with_labels):
    schema_json, gen = SCHEMAS[name]
    rows = gen(3000, seed=5)
    enc = _encoder(schema_json, rows)
    data = ("\n\n" + eol.join(",".join(map(str, r)) for r in rows)
            + eol + " \n").encode()
    block = _block(tmp_path, data)
    ncols = len(rows[0])
    want = native.encode_bytes(block.data, enc, ncols, ",",
                               with_labels=with_labels, with_ids=False)
    _same(_device_encode(block, enc, ncols, with_labels), want)


HOSP_ROW = ["P1", "31", "164", "67", "retired", "with partner", "poor", "low",
            "high", "non smoker", "low", "N"]


def _row(**fields):
    row = list(HOSP_ROW)
    for k, v in fields.items():
        row[int(k[1:])] = v
    return ",".join(row)


TAKEN = {
    "negatives_and_plus": [_row(f1="-31", f2="+164"), _row(f3="-0")],
    "decimals": [_row(f1="31.5", f2=".5"), _row(f3="67."), _row(f1="-.25")],
    "past_the_bins": [_row(f1="9999"), _row(f2="-12345.678"),
                      _row(f3="999999999999999")],
    "oov_categoricals": [_row(f4="student"), _row(f5=""), _row(f6=" poor"),
                         _row(f9="smoker\r")],
}
REFUSED = {
    "exponent": [_row(f1="3e1")],
    "sixteen_digits": [_row(f2="0000000000000164")],
    "leading_space": [_row(f3=" 67")],
    "empty_number": [_row(f1="")],
    "ragged_row": [_row(), _row() + ",extra"],
    "short_row": [",".join(HOSP_ROW[:6])],
    "unknown_label": [_row(f11="maybe")],
    "inf": [_row(f1="inf")],
}


def _hosp_block(tmp_path, lines):
    data = "\n".join([_row()] * 3 + lines + [_row()]).encode() + b"\n"
    return _block(tmp_path, data)


@pytest.mark.parametrize("case", sorted(TAKEN))
def test_plain_encode_takes_the_fast_path_fields(tmp_path, case):
    enc = _encoder(HOSP_SCHEMA_JSON, None)
    block = _hosp_block(tmp_path, TAKEN[case])
    want = native.encode_bytes(block.data, enc, 12, ",", with_ids=False)
    _same(_device_encode(block, enc, 12), want)


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_plain_encode_refuses_and_the_native_encode_decides(tmp_path, case):
    enc = _encoder(HOSP_SCHEMA_JSON, None)
    block = _hosp_block(tmp_path, REFUSED[case])
    assert _device_encode(block, enc, 12) is None
    decoder = tcsv.CsvDecoder(enc, True, "cpu")
    refused = base.encode_chunk.chunks_refused
    try:
        want = native.encode_bytes(block.data, enc, 12, ",", with_ids=False)
    except ValueError as e:
        with pytest.raises(ValueError, match=f"^{re.escape(str(e))}$"):
            base.encode_chunk("device", block, enc, 12, ",", True, False,
                              decoder)
    else:
        got, route = base.encode_chunk("device", block, enc, 12, ",", True,
                                       False, decoder)
        assert route == "native"
        np.testing.assert_array_equal(got.codes, want.codes)
        np.testing.assert_array_equal(got.labels, want.labels)
    assert base.encode_chunk.chunks_refused == refused + 1


def _refused_then_native(block, enc, ncols):
    """A chunk refused for its shape: the device route encodes it natively,
    to the native encoder's values."""
    assert _device_encode(block, enc, ncols) is None
    want = native.encode_bytes(block.data, enc, ncols, ",", with_ids=False)
    got, route = base.encode_chunk("device", block, enc, ncols, ",", True,
                                   False, tcsv.CsvDecoder(enc, True, "cpu"))
    assert route == "native"
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.labels, want.labels)


def test_a_tile_past_shared_memory_is_refused(tmp_path):
    enc = _encoder(HOSP_SCHEMA_JSON, None)
    wide = _row(f4="x" * (tcsv.SMEM_MAX + 1))
    block = _hosp_block(tmp_path, [wide])
    assert tcsv.tile_span(block.starts, block.rows) > tcsv.SMEM_MAX
    _refused_then_native(block, enc, 12)


WIDE_SCHEMA_JSON = {"fields": [
    {"name": f"x{i}", "ordinal": i, "dataType": "int", "feature": True,
     "bucketWidth": 100000, "min": 0, "max": 9999999} for i in range(150)
] + [{"name": "y", "ordinal": 150, "dataType": "categorical",
      "cardinality": ["N", "Y"]}]}


@pytest.mark.parametrize("rows", [128, 64])
def test_a_wide_schema_past_shared_memory_is_refused(tmp_path, rows):
    """150 binned columns of 7 digits, rows of 1.2 KB: a full tile's bytes
    (~154 KB) fit in shared memory alone, not beside its staged outputs
    (~77 KB) and the schema's tables (~6 KB), so the chunk is refused; a tile of half the rows fits and is
    encoded on the device route."""
    rng = np.random.default_rng(3)
    vals = rng.integers(1_000_000, 9_999_999, size=(rows, 150))
    data = "".join(",".join(map(str, r)) + f",{'NY'[i % 2]}\n"
                   for i, r in enumerate(vals)).encode()
    block = _block(tmp_path, data)
    enc = _encoder(WIDE_SCHEMA_JSON, None)
    spec = tcsv.CsvSpec(enc)
    span = tcsv.tile_span(block.starts, block.rows)
    if rows == 128:
        assert span < tcsv.SMEM_MAX < tcsv.smem_bytes(spec, 151, span)
        _refused_then_native(block, enc, 151)
    else:
        assert tcsv.smem_bytes(spec, 151, span) <= tcsv.SMEM_MAX
        want = native.encode_bytes(block.data, enc, 151, ",", with_ids=False)
        _same(_device_encode(block, enc, 151), want)


def test_the_device_route_follows_the_stage_and_the_device():
    cuda = torch.device("cuda")
    assert Job._decode_device(cuda, True) == cuda
    assert Job._decode_device(cuda, False) is None
    assert Job._decode_device(torch.device("cpu"), True) is None
    assert Job._decode_device(None, True) is None


@pytest.mark.parametrize("with_ids", [True, False])
def test_a_stream_that_reads_ids_stays_on_the_host(tmp_path, with_ids):
    d = tmp_path / "in"
    d.mkdir()
    (d / "part-0").write_bytes("".join(_row() + "\n" for _ in range(5)
                                       ).encode())
    conf = JobConfig()
    conf.set("field.delim.regex", ",")
    enc = _encoder(HOSP_SCHEMA_JSON, None)
    before = (base.encode_chunk.rows_device, base.encode_chunk.rows_native)
    got = list(Job.iter_encoded_retrying(conf, str(d), enc, Counters(),
                                         with_ids=with_ids, device="cpu"))
    after = (base.encode_chunk.rows_device, base.encode_chunk.rows_native)
    assert [b - a for a, b in zip(before, after)] == (
        [0, 5] if with_ids else [5, 0])
    assert len(got) == 1 and got[0].num_rows == 5
    assert (got[0].ids is not None) == with_ids


# -- the pipeline through the device route's decode --------------------------

def _pipeline_inputs(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    for p in range(3):
        rows = generate_hosp_readmit(2500, seed=40 + p)
        eol = "\r\n" if p == 1 else "\n"
        text = eol.join(",".join(map(str, r)) for r in rows) + eol
        (data / f"part-{p:05d}").write_bytes(("\n" + text + " \n").encode())
    schema = tmp_path / "hosp.json"
    schema.write_text(json.dumps(HOSP_SCHEMA_JSON))
    props = {"pipeline.stages": "bayes,mi",
             "pipeline.stage.bayes.job": "BayesianDistribution",
             "pipeline.stage.bayes.input": "data",
             "pipeline.stage.bayes.output": "bayes",
             "pipeline.stage.mi.job": "MutualInformation",
             "pipeline.stage.mi.input": "data",
             "pipeline.stage.mi.output": "mi",
             "field.delim.regex": ",", "stream.chunk.rows": "1000",
             "stream.prefetch.depth": "2",
             "feature.schema.file.path": str(schema),
             "pipeline.bind.data": str(data)}
    return props


def _run(tmp_path, props, name):
    conf = JobConfig()
    for k, v in props.items():
        conf.set(k, v)
    conf.set("pipeline.workspace", str(tmp_path / name))
    Pipeline.from_conf(conf, device="cpu").run()
    return {s: (tmp_path / name / s / "part-00000").read_bytes()
            for s in ("bayes", "mi")}


def test_pipeline_through_the_device_decode_writes_the_host_files(
        tmp_path, monkeypatch):
    props = _pipeline_inputs(tmp_path)
    host = _run(tmp_path, props, "host")
    rows, native_rows = (base.encode_chunk.rows_device,
                         base.encode_chunk.rows_native)
    monkeypatch.setattr(Job, "_decode_device",
                        staticmethod(lambda device, staged: device))
    device = _run(tmp_path, props, "device")
    assert base.encode_chunk.rows_device - rows == 3 * 2500
    assert base.encode_chunk.rows_native == native_rows
    assert device == host and all(host.values())

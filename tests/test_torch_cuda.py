"""The port's CUDA kernel on the card: the co-occurrence gram
(``csrc/cooc.cu``) against its plain PyTorch version, exactly.

Every test here needs an NVIDIA GPU and skips where there is none.  The
file imports neither JAX nor the JAX package, so on a machine without JAX
it runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from avenir_tpu_torch.core.encoding import DatasetEncoder  # noqa: E402
from avenir_tpu_torch.core.schema import FeatureSchema  # noqa: E402
from avenir_tpu_torch.datagen.hosp_readmit import (  # noqa: E402
    HOSP_SCHEMA_JSON, generate_hosp_readmit)
from avenir_tpu_torch.models import mutual_info as mi  # noqa: E402
from avenir_tpu_torch.ops import hist  # noqa: E402


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _data(n, f, b, c, seed):
    """codes_t [F, N], labels [N] int32 with dropped cells (-1, B, B+5) and
    dropped rows (-1, C)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b, size=(f, n)).astype(np.int32)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    if n:
        for val in (-1, b, b + 5):
            codes[rng.integers(0, f, 8), rng.integers(0, n, 8)] = val
        for val in (-1, c):
            labels[rng.integers(0, n, 5)] = val
    return codes, labels


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,b,c", [
    (4099, 11, 12, 2),     # bench shape, ragged tail
    (2500, 10, 13, 2),     # the CSV job's shape
    (3000, 20, 3, 2),      # jmaj
    (5000, 200, 1, 2),     # jmaj, more features than a tile
    (777, 3, 30, 2),       # fmaj, jcp 64
    (1000, 4, 5, 3),       # C = 3
    (0, 11, 12, 2),        # empty chunk: zeros, no launch
])
def test_kernel_matches_plain_version(cuda, n, f, b, c):
    codes, labels = _data(n, f, b, c, seed=13)
    ct, lb = torch.from_numpy(codes).to(cuda), torch.from_numpy(labels).to(cuda)
    before = hist.cooc_counts_cols.launches
    g = hist.cooc_counts_cols(ct, lb, b, c)
    assert hist.cooc_counts_cols.launches == before + (1 if n else 0)
    torch.cuda.synchronize()
    assert g.device.type == "cuda" and g.dtype == torch.int32
    assert torch.equal(g.cpu(), hist.cooc_counts_cols_ref(
        torch.from_numpy(codes), torch.from_numpy(labels), b, c))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    codes, labels = _data(100, 20, 20, 2, seed=1)
    ct, lb = torch.from_numpy(codes).to(cuda), torch.from_numpy(labels).to(cuda)
    with pytest.raises(NotImplementedError):          # cls mode: B2
        hist.cooc_counts_cols(ct, lb, 20, 2)
    with pytest.raises(ValueError):                   # strided codes
        hist.cooc_counts_cols(ct[:, ::2], lb[::2].contiguous(), 3, 2)


@pytest.mark.cuda
def test_mi_fit_on_the_card_equals_cpu(cuda):
    enc = DatasetEncoder(FeatureSchema.from_json(HOSP_SCHEMA_JSON))
    ds = enc.fit_transform(generate_hosp_readmit(3000, seed=5))
    chunks = [ds.slice(s, s + 1000) for s in range(0, ds.num_rows, 1000)]
    before = hist.cooc_counts_cols.launches
    got = mi.MutualInformation().fit(chunks)          # default device: cuda
    assert hist.cooc_counts_cols.launches == before + len(chunks)
    want = mi.MutualInformation(device="cpu").fit(chunks)
    for name in ("class_counts", "feature_class_counts", "pair_class_counts"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(got.feature_class_mi, want.feature_class_mi)

"""The port's rig canaries (``avenir_tpu_torch/utils/rig_canary.py``)
against the JAX package's (``avenir_tpu/utils/rig_canary.py``), on the
CPU at small sizes.

Each canary's step, on the same seeded bf16 inputs, equals the JAX
module's step written in jnp (the same expression: the bf16 product with
float32 accumulation, the data-dependent carry scaled by 1e-30, and for
the kNN dot the reference tiles under ``lax.scan`` with a running row
max).  The inputs are bf16 on both sides and every product of two bf16
values is exact in float32, so the two differ only by the order of the
float32 sums: held within 1e-5 relative to the largest |value|.  Each
canary returns a finite time ≥ 0 on the CPU, and the healthy bar is one
constant that the sentinel and the profile read.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avenir_tpu.utils import rig_canary as jcanary
from avenir_tpu_torch.telemetry import __main__ as tel_main
from avenir_tpu_torch.telemetry import sentinel
from avenir_tpu_torch.utils import rig_canary

RTOL = 1e-5          # relative to the largest |value|: f32 summation order


def _bf16_pair(shape, seed):
    """The same seeded normals as a bf16 torch tensor and a bf16 jnp
    array (both round the float32 draw to nearest even)."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return (torch.from_numpy(x).to(torch.bfloat16),
            jnp.asarray(x).astype(jnp.bfloat16))


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-300)
    assert np.abs(got - want).max() <= RTOL * scale, (got, want)


@pytest.mark.parametrize("carry", [0.0, 0.37, -1.5])
def test_matmul_step_equals_jax(carry):
    a_t, a_j = _bf16_pair((64, 64), 0)

    @jax.jit
    def jstep(x, c):                 # avenir_tpu/utils/rig_canary.py's step
        out = jnp.dot(x + c.astype(jnp.bfloat16), a_j,
                      preferred_element_type=jnp.float32)
        return out[0, 0] * jnp.float32(1e-30), out

    want, want_out = jstep(a_j, jnp.float32(carry))
    got = rig_canary.matmul_step(a_t)(a_t, torch.tensor(carry))
    assert got.dtype == torch.float32 and got.shape == ()
    _close(float(got), float(want))
    # the whole product, not only the carried element
    _close(rig_canary.dot_f32(a_t + torch.tensor(carry).to(torch.bfloat16),
                              a_t).numpy(), want_out)


@pytest.mark.parametrize("carry", [0.0, 0.25])
def test_knn_dot_step_equals_jax(carry):
    tile = 1024
    q_t, q_j = _bf16_pair((32, 16), 1)
    r_t, r_j = _bf16_pair((4096, 16), 2)
    tiles_t = r_t.reshape(-1, tile, 16)
    tiles_j = r_j.reshape(-1, tile, 16)

    @jax.jit
    def jstep(x, c):                 # avenir_tpu/utils/rig_canary.py's step
        xq = x + c.astype(x.dtype)

        def body(best, r):
            d = jnp.dot(xq, r.T, preferred_element_type=jnp.float32)
            return jnp.maximum(best, d.max(axis=1)), None

        init = jnp.full((x.shape[0],), -jnp.inf, jnp.float32)
        best, _ = jax.lax.scan(body, init, tiles_j)
        return best[0] * jnp.float32(1e-30), best

    want, want_best = jstep(q_j, jnp.float32(carry))
    got = rig_canary.knn_dot_step(tiles_t)(q_t, torch.tensor(carry))
    _close(float(got), float(want))
    xq = q_t + torch.tensor(carry).to(torch.bfloat16)
    best = torch.stack([rig_canary.dot_f32(xq, r.T).amax(dim=1)
                        for r in tiles_t]).amax(dim=0)
    _close(best.numpy(), want_best)


def test_canaries_return_finite_times_on_the_cpu():
    ms = rig_canary.matmul_canary_ms(dim=64, reps=4, device="cpu")
    assert np.isfinite(ms) and ms >= 0.0
    tile = rig_canary.KNN_TILE
    ms = rig_canary.knn_dot_canary_ms(batch=32, n_refs=tile, width=16,
                                      reps=2, device="cpu")
    assert np.isfinite(ms) and ms >= 0.0
    refs = torch.randn(2 * tile + 5, 16).to(torch.bfloat16)  # 2 whole tiles
    ms = rig_canary.knn_dot_canary_ms(batch=32, reps=2, refs=refs)
    assert np.isfinite(ms) and ms >= 0.0
    with pytest.raises(ValueError, match=f"no whole {tile}-row tile"):
        rig_canary.knn_dot_canary_ms(batch=8, n_refs=tile - 1, width=16,
                                     device="cpu")


def test_canaries_run_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is attached")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rig_canary.matmul_canary_ms(dim=8)


def test_defaults_follow_the_jax_module():
    for ours, theirs in ((rig_canary.matmul_canary_ms,
                          jcanary.matmul_canary_ms),
                         (rig_canary.knn_dot_canary_ms,
                          jcanary.knn_dot_canary_ms)):
        want = {k: p.default for k, p in
                inspect.signature(theirs).parameters.items()}
        got = {k: p.default for k, p in
               inspect.signature(ours).parameters.items()}
        assert {k: got[k] for k in want} == want
    assert rig_canary.MATMUL_DIM == 4096 and rig_canary.KNN_TILE == 16384


def test_one_healthy_bar_read_by_the_sentinel_and_the_profile():
    assert sentinel.CANARY_HEALTHY_MS is rig_canary.CANARY_HEALTHY_MS
    # the card's bar lies below the JAX package's TPU bar
    assert 0 < rig_canary.CANARY_HEALTHY_MS < 7.0
    assert tel_main._CANARY_FLOPS_PER_CALL == 2.0 * rig_canary.MATMUL_DIM ** 3
    # a 0.25 ms canary in a journal: the profile's peak at 2·4096³ / 0.25 ms
    peak = tel_main.canary_peak_flops([{"ev": "canary", "ms": 0.3},
                                       {"ev": "canary", "ms": 0.25}])
    assert peak == pytest.approx(2.0 * 4096 ** 3 / 0.25e-3)

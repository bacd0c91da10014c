"""The card's canary: a chained 4096³ bf16 matmul timed by CUDA events.

A frozen copy of ``matmul_canary_ms`` in
``avenir_tpu_torch/utils/rig_canary.py``: cuBLAS and the card, no code of
the program, so a slow reading says the card is slow.  Each step chains a
0-d carry into the next step's operand, and the per-call time is the
two-point slope of two chain lengths, which drops the chain's constant
cost.  It is printed on an earlier line of a run, never as a metric.
"""

from __future__ import annotations

DIM = 4096


def matmul_canary_ms(device, dim: int = DIM, reps: int = 16) -> float:
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((dim, dim), generator=gen, device=device,
                    dtype=torch.float32).to(torch.bfloat16)

    def step(carry):
        out = torch.mm(a + carry.to(torch.bfloat16), a,
                       out_dtype=torch.float32)
        return out[0, 0] * 1e-30

    def chain(n: int) -> float:
        carry = torch.zeros((), dtype=torch.float32, device=device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            carry = step(carry)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    chain(2)
    chain(2 + reps)
    lo = min(chain(2) for _ in range(2))
    hi = min(chain(2 + reps) for _ in range(2))
    return max((hi - lo) / reps, 0.0)

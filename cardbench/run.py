"""Run one cell of ``BENCHMARK.json`` on this machine's card.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Sets the cell up from the seed, drives it
for ``--seconds`` in a closed loop, checks what the window produced
against the plain reference and prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s``, and a ``breakdown``), and last ``checks``, each number
compared beside its limit.  Exits non-zero, with no result, where there
is no CUDA card or fewer than the cell asks for, where the program is
not in the checkout, or where the run loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this directory, heads the import path
sys.path[0] = ROOT


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from cardbench import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark measures the port alone: nothing it runs imports JAX or
the JAX package (top-level names compared whole), the references import
nothing of the program, and nothing reads the TPU-era benchmarks."""

import ast
import glob
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "avenir_tpu"}
PROGRAM = "avenir_tpu_torch"


def sources(pattern="**/*.py"):
    return [p for p in glob.glob(os.path.join(BENCH, pattern), recursive=True)
            if os.sep + "tests" + os.sep not in p]


def top_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sources(),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    assert not top_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sources("configs/*/reference.py")
                         + sources("configs/*/compare.py")
                         + sources("yardstick/*.py"),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_and_yardstick_import_nothing_of_the_program(path):
    assert PROGRAM not in top_imports(path)


def test_nothing_reads_the_tpu_era_benchmarks():
    for path in sources():
        text = open(path).read()
        for name in ("benchmarks/", "bench.py", "BASELINE.json", "BENCH_r0",
                     "MULTICHIP_r0", "PACK_SWEEP"):
            assert name not in text, (path, name)


def test_a_cpu_run_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from cardbench import harness\n"
        "from cardbench.tests.small import SMALL\n"
        "cell = harness.Cell(harness.load_benchmark(), 'elearn_knn.r10k')\n"
        "harness.run_cell(cell, 5, 0.2, False, time.perf_counter(), "
        "device='cpu', traffic=SMALL['elearn_knn'])\n"
        "print(harness.forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"

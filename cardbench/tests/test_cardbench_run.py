"""The command's exits: no result without a card, without the program,
or in a checkout that holds only the benchmark; and one cell on a card."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

from cardbench import harness, program

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
ARGS = ["--workload", "hosp_readmit.c16m", "--seed", str(2**31 + 3),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "cardbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "cardbench"), tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""


def test_without_the_program_no_result(monkeypatch, capsys):
    monkeypatch.setattr(harness, "check_device", lambda chips: None)
    monkeypatch.setattr(program, "present", lambda: False)
    args = SimpleNamespace(workload="hosp_readmit.c16m", seed=1, seconds=1.0,
                           trace=0)
    assert harness.main(args, 0.0) == 4
    assert capsys.readouterr().out == ""


def test_unknown_cell_no_result(monkeypatch, capsys):
    args = SimpleNamespace(workload="no_such.cell", seed=1, seconds=1.0,
                           trace=0)
    assert harness.main(args, 0.0) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["hosp_readmit.c16m", "elearn_knn.r1m",
                                  "hosp_readmit.c1m", "elearn_knn.r10k"])
@pytest.mark.parametrize("trace", ["0", "1"])
def test_cell_on_the_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 77), "--seconds", "2", "--trace", trace],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    if trace == "1":
        assert result["device"]["busy_s"] > 0

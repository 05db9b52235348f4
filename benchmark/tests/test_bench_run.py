"""The command refuses to run without a card, or without the program, and
prints no result."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ARGS = ["--workload", "splat.render", "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"]


def run(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *ARGS], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal is for machines without one")
    out = run(harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_only_the_benchmark_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's files."""
    shutil.copy(harness.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_unknown_cell():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "nope", "--seed", "1", "--seconds",
                          "1"], cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""

"""Nothing the benchmark runs imports JAX or the JAX package, and its plain
references import nothing of the measured program. Module names are
compared by their whole top-level part: ``gaussctrl_exp_tpu_torch`` begins
with ``gaussctrl_exp_tpu`` and is allowed."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from benchmark import harness

SOURCES = sorted(p for p in harness.BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_imports(path) -> set[str]:
    """Top-level names of every module ``path`` imports (relative imports are the benchmark's own)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_jax(path):
    assert not harness.forbidden_modules(top_imports(path))


@pytest.mark.parametrize("path", sorted((harness.BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_is_independent_of_the_program(path):
    assert not {"gaussctrl_exp_tpu_torch", "gaussctrl_exp_tpu"} & top_imports(path)
    assert "benchmark" not in top_imports(path)  # only its own relative imports


def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules(["gaussctrl_exp_tpu_torch", "gaussctrl_exp_tpu_torch.ops", "jaxtyping",
                                      "flaxen", "numpy"]) == []
    assert harness.forbidden_modules(["jax", "jax.numpy", "gaussctrl_exp_tpu.ops", "optax", "flax.linen",
                                      "jaxlib"]) == ["flax.linen", "gaussctrl_exp_tpu.ops", "jax", "jax.numpy",
                                                     "jaxlib", "optax"]


def test_importing_every_runner_loads_no_jax():
    code = ("import sys, benchmark.run, benchmark.controls\n"
            "from benchmark import harness\n"
            "for d in harness.parts()['runners']: harness.runner(d)\n"
            "import gaussctrl_exp_tpu_torch.diffusion.pipeline, gaussctrl_exp_tpu_torch.engine.trainer\n"
            "print(harness.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

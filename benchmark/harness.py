"""Finds the parts of a cell by name, and judges a run's compared numbers.

``BENCHMARK.json`` names each cell's configuration and traffic mix. The
configuration is ``benchmark/configs/<config>.json``; the traffic mix is
``benchmark/traffic/<traffic>.json``, whose ``runner`` names the module
``benchmark/runners/<runner>.py`` that sets the program up, runs its unit of
work over the window and checks what it produced; each per-layer metric is
read by ``benchmark/metrics/<metric>.py``, whose ``read(run)`` returns a
number or None. A later cell, mix or metric is added as files and a manifest
entry; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"
# top-level module names the measured process must never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gaussctrl_exp_tpu")


class CellError(Exception):
    """A cell, configuration, mix or metric that the files do not define."""


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_manifest(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def load_json(kind: str, name: str, bench: Path = BENCH) -> dict:
    path = bench / kind / f"{name}.json"
    if not path.is_file():
        raise CellError(f"no {kind[:-1] if kind.endswith('s') else kind} file {path.relative_to(bench.parent)}")
    return json.loads(path.read_text())


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, manifest: dict | None = None, bench: Path = BENCH) -> Cell:
    manifest = manifest or load_manifest(bench.parent / "BENCHMARK.json")
    work = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if work is None:
        raise CellError(f"no workload {name!r} in BENCHMARK.json; have {[w['name'] for w in manifest['workloads']]}")
    return Cell(
        name=name,
        workload=work,
        config=load_json("configs", work["config"], bench),
        traffic=load_json("traffic", work["traffic"], bench),
        end_to_end=[m for m in manifest["end_to_end"] if _for_cell(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _for_cell(m, name)],
    )


def runner(name: str) -> ModuleType:
    if not (BENCH / "runners" / f"{name}.py").is_file():
        raise CellError(f"no runner benchmark/runners/{name}.py")
    return importlib.import_module(f"benchmark.runners.{name}")


def metric_reader(name: str, bench: Path = BENCH) -> ModuleType:
    """``benchmark/metrics/<name>.py`` loaded by path (metric names hold dots)."""
    path = bench / "metrics" / f"{name}.py"
    if not path.is_file():
        raise CellError(f"no reader benchmark/metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parts(bench: Path = BENCH) -> dict[str, list[str]]:
    """Every configuration, mix, runner and metric reader the files define."""
    def names(kind, suffix):
        return sorted(p.name[: -len(suffix)] for p in (bench / kind).glob(f"*{suffix}") if not p.name.startswith("_"))

    return dict(configs=names("configs", ".json"), traffic=names("traffic", ".json"),
                runners=names("runners", ".py"), metrics=names("metrics", ".py"))


def forbidden_modules(modules) -> list[str]:
    """Names among ``modules`` whose top-level part is forbidden, compared whole."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def judge(checks: list[tuple[str, float, float]]) -> bool:
    """Correct when every compared number is finite and within its limit."""
    return bool(checks) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)

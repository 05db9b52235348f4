"""BENCHMARK.json against the benchmark's contract, and the harness finding
each part of a cell by name."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|experts_per_tok|_dim$|_rank$)")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape_and_limits(manifest):
    assert set(manifest) == KEYS["top"]
    assert harness.MANIFEST.stat().st_size <= 64 * 1024
    assert 1 <= len(manifest["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in manifest["paths"])
    assert all(not p.endswith("_torch") for p in manifest["paths"])
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) and not w.startswith("/") for w in cmd)
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    # a full check with 24 cells fits a full check's time budget
    rs = manifest["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries(manifest, kind):
    entries = manifest[kind]
    assert entries and len({e["name"] for e in entries}) == len(entries)
    allowed = KEYS[{"configs": "config", "workloads": "workload"}.get(kind, kind)]
    for e in entries:
        assert set(e) <= allowed and set(e) >= allowed - {"workloads"}, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if kind in ("end_to_end", "per_layer"):
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e and kind != "end_to_end":
                assert _line(e[k]), (e["name"], k)


def test_metrics_names_unique_across_kinds(manifest):
    names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(names) == len(set(names))


def test_configs(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    for c in manifest["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in manifest["paths"]))
        body = json.loads((harness.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert len(c["reduced"]) <= 16 and not any(WIDTH.search(k) for k in c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["source"].startswith("https://")
    assert len({c["file"] for c in manifest["configs"]}) == len(manifest["configs"])


def test_cells(manifest):
    pairs = {(w["config"], w["traffic"]) for w in manifest["workloads"]}
    assert len(pairs) == len(manifest["workloads"]) <= 24
    four = [w for w in manifest["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(manifest["workloads"]) // 4)
    for w in manifest["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"]) and NAME.match(w["config"])
        cell = harness.find_cell(w["name"], manifest)
        assert cell.traffic["runner"] in harness.parts()["runners"]
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]


def test_metrics(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells)), m["name"]
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_a_layer_metric_moving_its_metric(manifest):
    for w in manifest["workloads"]:
        cell = harness.find_cell(w["name"], manifest)
        reported = {m["name"] for m in cell.end_to_end}
        assert any(m["moves"] in reported for m in cell.per_layer), w["name"]


def test_a_new_part_is_found_by_name(tmp_path):
    """A later cell, mix, configuration and metric are files and a manifest
    entry: nothing that is there is edited."""
    shutil.copytree(harness.BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    manifest = harness.load_manifest()
    bench = tmp_path / "benchmark"
    (bench / "configs" / "dummy-model.json").write_text(json.dumps({"name": "dummy-model"}))
    (bench / "traffic" / "dummy.json").write_text(json.dumps({"runner": "splat_render", "limits": {}}))
    (bench / "metrics" / "dummy_ms.render.py").write_text("def read(run):\n    return None\n")
    manifest["configs"].append(dict(name="dummy-model", source="https://example.org", file="benchmark/configs/dummy-model.json",
                                    reduced=[], why="a test"))
    manifest["workloads"].append(dict(name="dummy.cell", config="dummy-model", traffic="dummy", chips=1, why="a test"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    found = harness.parts(bench)
    assert "dummy-model" in found["configs"] and "dummy" in found["traffic"] and "dummy_ms.render" in found["metrics"]
    cell = harness.find_cell("dummy.cell", bench=bench)
    assert cell.config == {"name": "dummy-model"} and cell.traffic["runner"] == "splat_render"
    assert harness.metric_reader("dummy_ms.render", bench).read({}) is None


def test_unknown_names_are_refused(manifest):
    with pytest.raises(harness.CellError):
        harness.find_cell("no.such.cell", manifest)
    with pytest.raises(harness.CellError):
        harness.runner("no_such_runner")
    with pytest.raises(harness.CellError):
        harness.metric_reader("no_such_metric.x")

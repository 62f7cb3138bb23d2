"""The benchmark's files against its contract: names, keys, units, bounds,
the metrics each cell reports, the files found by name, the isolation
from the JAX package, and a new configuration, cell and metric added as
files alone."""

from __future__ import annotations

import ast
import json
import math
import re
from pathlib import Path

import pytest

from perfbench.harness import core

BENCH = core.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and c["file"] not in files
        files.add(c["file"])
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["reduced"] == core.load_json(core.ROOT / c["file"])["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_cells_and_their_files():
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = set()
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["config"] in configs
        assert NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        wl = core.load_json(core.workload_file(w["name"]))
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"] and wl["why"] == w["why"]
        assert (core.HERE / "drivers" / f"{wl['driver']}.py").is_file()
        assert all(math.isfinite(v) and v >= 0 for v in wl["limits"].values())


def test_metrics_keys_units_and_bounds():
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and TEXT.match(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert all(w in CELLS for w in m.get("workloads", []))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = {m["name"] for m in core.metrics_of(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = core.metrics_of(BENCH, cell, "per_layer")
    assert layer
    for m in layer:  # every cell that reports a layer metric reports what it moves
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_matches_its_entry(metric):
    entry = {m["name"]: m for m in BENCH["per_layer"]}[metric]
    reader = core.metric_reader(metric)
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])
    assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_layer_names_agree_letter_for_letter():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_the_jax_package_or_its_ecosystem():
    for path in core.HERE.rglob("*.py"):
        assert not (_imports(path) & set(core.FORBIDDEN)), path


def test_reference_imports_nothing_of_the_program():
    for path in (core.HERE / "reference").rglob("*.py"):
        assert core.PROGRAM not in _imports(path), path


def test_isolation_check_compares_whole_top_level_names():
    assert core.forbidden_modules(["viscoin_tpu_torch", "viscoin_tpu_torch.ops", "torch"]) == []
    assert core.forbidden_modules(["viscoin_tpu.models", "jaxlib.xla_client", "flax"]) == [
        "flax", "jaxlib", "viscoin_tpu"]
    assert core.forbidden_modules(["jaxtyping", "optax_like"]) == []


def test_files_under_paths_are_named_from_name_characters():
    for path in core.HERE.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(core.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel) and len(rel) <= 200, rel


def test_new_config_cell_and_metric_are_found_as_files_alone(tmp_path):
    base = tmp_path / "perfbench"
    for sub in ("configs", "workloads", "metrics"):
        (base / sub).mkdir(parents=True)
    (base / "configs" / "toy-cfg.json").write_text(json.dumps({"sizes": {"n": 1}, "reduced": []}))
    (base / "workloads" / "toy-cfg.cell.json").write_text(json.dumps(
        {"config": "toy-cfg", "driver": "train_gan", "chips": 1, "why": "x", "params": {},
         "limits": {}}))
    (base / "metrics" / "toy_share.x.py").write_text(
        "LAYER = 'toy'\nUNIT = '%'\nSOURCE = 'program_counter'\nMOVES = 'train_img_s'\n"
        "def read(ctx):\n    return ctx.layer.get('toy')\n")
    bench = dict(BENCH)
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "toy_share.x", "unit": "%", "better": "higher", "source": "program_counter",
         "layer": "toy", "moves": "train_img_s", "workloads": ["toy-cfg.cell"]}]
    wl = core.load_json(core.workload_file("toy-cfg.cell", base))
    assert core.load_json(core.config_file(wl["config"], base))["sizes"] == {"n": 1}
    assert [m["name"] for m in core.metrics_of(bench, "toy-cfg.cell", "per_layer")] == [
        "toy_share.x"]
    ctx = core.Context(cell="toy-cfg.cell", wl=wl, config={}, seed=1, seconds=1.0, traced=True,
                       t_start=0.0)
    reader = core.metric_reader("toy_share.x", base)
    assert reader.read(ctx) is None  # nothing to read: the metric is left out
    ctx.layer["toy"] = 42.0
    assert reader.read(ctx) == 42.0

"""The benchmark's manifest and its data-driven layout, on the CPU.

``BENCHMARK.json`` keeps to its format (names, units, keys,
bounds, the four-chip share, the run length that fits a full check); every
cell, configuration, traffic mix, limit and metric it names has its file
under ``portbench/``; and a cell, a mix and a metric added as files and
entries in a copy are found by name, with no code edited. No module of
the harness imports JAX or the JAX package ``repro``, and the yardstick
(``reference/``, ``metrics/``) imports nothing of the program.
"""
from __future__ import annotations

import ast
import json
import os
import re
import shutil

import pytest

from portbench import run as harness

ROOT = harness.ROOT
BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _py_files(*sub):
    base = os.path.join(ROOT, "portbench", *sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits: runs of run_seconds + 60, two compiles
    # a cell, 1,200 s spare
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_have_their_keys_and_names(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[section] <= set(e) <= ENTRY_KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", f"{metric['name']}.py"))
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_setup_s_is_reported_everywhere():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=[m["name"] for m in BENCH["per_layer"]])
def test_per_layer_moves_a_metric_its_cells_report(metric):
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    assert metric["workloads"], metric["name"]  # the harness reads a per-layer metric's cells
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", CELLS), (metric["name"], cell)
    assert "\n" not in metric["layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_end_to_end_and_a_per_layer(cell):
    e2e = {m["name"] for m in harness.metrics_of(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(BENCH, cell, True)


def test_cells_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = harness.make_cell(BENCH, cell, 1, 1.0, False, "cpu")
    assert os.path.exists(os.path.join(ROOT, "portbench", "drivers",
                                       f"{c.config['driver']}.py"))
    assert set(c.limits) == {"loss_gap", "grad_gap", "change_gap"}
    assert all(v > 0 for v in c.limits.values())


@pytest.mark.parametrize("config", BENCH["configs"], ids=[c["name"] for c in BENCH["configs"]])
def test_config_file(config):
    assert config["file"] == f"portbench/configs/{config['name']}.json"
    with open(os.path.join(ROOT, config["file"])) as f:
        body = json.load(f)
    assert body["name"] == config["name"] and body["source"] == config["source"]
    assert body["reduced"] == config["reduced"]
    widths = re.compile(r"(_dim|_rank)$|^(d_model|d_ff|hidden|intermediate|n_heads|head)")
    assert not any(widths.search(k) for k in config["reduced"])


def test_a_cell_mix_and_metric_added_as_files_are_found(tmp_path):
    """A later change adds a traffic mix, a cell, a limit file and a
    per-layer metric by files and entries alone; the harness finds each by
    name in the copy."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    mix = json.load(open(root / "portbench" / "mixes" / "sim-easgd.b4096.json"))
    mix.update(name="sim-easgd.b1024", batch_per_thread=1024)
    json.dump(mix, open(root / "portbench" / "mixes" / "sim-easgd.b1024.json", "w"))
    shutil.copy(root / "portbench" / "limits" / "dlrm-ctr.sim-easgd.b4096.json",
                root / "portbench" / "limits" / "dlrm-ctr.sim-easgd.b1024.json")
    (root / "portbench" / "metrics" / "iters.dlrm.py").write_text(
        "def read(rec):\n    return rec.get('iters')\n")
    bench["workloads"].append({"name": "dlrm-ctr.sim-easgd.b1024", "config": "dlrm-ctr",
                               "traffic": "sim-easgd.b1024", "chips": 1, "why": "smaller"})
    bench["per_layer"].append({"name": "iters.dlrm", "unit": "iterations", "better": "higher",
                               "source": "host_clock", "layer": "runner dispatch",
                               "moves": "examples_per_s",
                               "workloads": ["dlrm-ctr.sim-easgd.b1024"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("examples_per_s", "step_ms.p95"):
            m["workloads"].append("dlrm-ctr.sim-easgd.b1024")
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    bench = harness.manifest(str(root))
    cell = harness.make_cell(bench, "dlrm-ctr.sim-easgd.b1024", 7, 1.0, True, "cpu",
                             root=str(root))
    assert cell.mix["batch_per_thread"] == 1024
    names = [m["name"] for m in harness.metrics_of(bench, cell.name, True)]
    assert names == ["iters.dlrm"]
    reader = harness.load_module("metrics", "iters.dlrm", cell.root)
    assert reader.read({"iters": 3}) == 3
    assert harness.load_module("drivers", cell.config["driver"], cell.root).run


@pytest.mark.parametrize("path", sorted(_py_files()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


@pytest.mark.parametrize("path", sorted(list(_py_files("reference")) + list(_py_files("metrics"))),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_yardstick_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert "repro_torch" not in tops, path

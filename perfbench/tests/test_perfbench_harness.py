"""The harness finds a cell's files by name, BENCHMARK.json keeps to the
contract's characters and keys, a cell added as files alone is found, and
nothing under perfbench/ imports JAX or the JAX package (the reference
nothing of the port)."""

import ast
import json
import re
import shutil

import pytest

from perfbench.core import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def benchmark():
    return bench.load_benchmark()


def test_every_cell_loads_its_files_by_name():
    b = benchmark()
    for w in b["workloads"]:
        cell = bench.load_cell(w["name"])
        assert cell.traffic["driver"]
        assert hasattr(bench.driver(cell), "run")
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(bench.metric_reader(m["name"]))


def test_names_units_and_keys_keep_to_the_contract():
    b = benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in b[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    assert 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_metric_lists_name_cells_that_report_the_moved_metric():
    b = benchmark()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", []):
            assert cell in moved.get("workloads", [cell])


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A fixture-only cell: a new configuration file, traffic file and
    metric reader and a new BENCHMARK.json entry, no edit of a file that
    was there."""
    root = tmp_path / "ckout"
    shutil.copytree(bench.ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = benchmark()
    (root / "perfbench" / "configs" / "fixture-model.json").write_text(
        (bench.ROOT / "perfbench" / "configs"
         / "ax-encoder-base-splade.json").read_text())
    traffic = json.loads((bench.ROOT / "perfbench" / "traffic"
                          / "postings_1m5_poisson.json").read_text())
    traffic["rate_per_s"] = 7
    (root / "perfbench" / "traffic" / "fixture_mix.json").write_text(
        json.dumps(traffic))
    (root / "perfbench" / "metrics" / "serve.fixture_ms.py").write_text(
        "def read(ctx):\n    return 1.5\n")
    b["configs"].append({"name": "fixture-model", "source": "x",
                         "file": "perfbench/configs/fixture-model.json",
                         "reduced": [], "why": "fixture"})
    b["workloads"].append({"name": "fixture_cell", "config": "fixture-model",
                           "traffic": "fixture_mix", "chips": 1,
                           "why": "fixture"})
    b["per_layer"].append({"name": "serve.fixture_ms", "unit": "ms",
                           "better": "lower", "source": "program_span",
                           "layer": "engine", "moves": "search_p50_ms",
                           "workloads": ["fixture_cell"]})
    b["end_to_end"] += [{"name": f"search_{q}_ms", "unit": "ms",
                         "better": "lower", "bound": 0.25,
                         "source": "host_clock", "workloads": ["fixture_cell"]}
                        for q in ("p50", "p95")]
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = bench.load_cell("fixture_cell", root)
    assert cell.traffic["rate_per_s"] == 7
    assert bench.driver(cell, root).run
    assert bench.metric_reader("serve.fixture_ms", root)({}) == 1.5
    assert "serve.fixture_ms" in [m["name"] for m in cell.per_layer]
    assert {m["name"] for m in cell.end_to_end} == {
        "search_p50_ms", "search_p95_ms", "setup_s"}
    assert [m["name"] for m in bench.load_cell("train_v33", root).per_layer
            ] == [m["name"] for m in bench.load_cell("train_v33").per_layer]


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", sorted(
    p.relative_to(bench.ROOT).as_posix()
    for p in (bench.ROOT / "perfbench").rglob("*.py")))
def test_no_jax_and_a_reference_of_its_own(path):
    full = bench.ROOT / path
    tops = {m.split(".", 1)[0] for m in _imports(full)}
    assert not tops & set(bench.FORBIDDEN), (path, tops)
    if path.startswith("perfbench/reference/"):
        assert "splade_tpu_torch" not in tops, path
    for config in (bench.ROOT / "perfbench" / "traffic").glob("*.json"):
        module = json.loads(config.read_text()).get("index", {}).get("module")
        if module:
            assert module.split(".", 1)[0] not in bench.FORBIDDEN


def test_forbidden_modules_are_named_by_whole_top_level_name(monkeypatch):
    import sys
    import types

    for name in list(sys.modules):  # whatever this test process loaded
        if name.split(".", 1)[0] in bench.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "splade_tpu_torchlike", types.ModuleType(
        "splade_tpu_torchlike"))
    assert bench.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert bench.forbidden_loaded() == ["jax"]

"""BENCHMARK.json and the files it names keep the contract's rules."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from gpu_bench.harness import env
from gpu_bench.harness.spec import BENCH_DIR, ROOT, SPEC_PATH, check_names, load_cell, reader_path

SPEC = json.loads(SPEC_PATH.read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_names_and_units_use_allowed_characters():
    assert check_names(SPEC) == []


def test_check_names_catches_a_bad_name():
    bad = json.loads(json.dumps(SPEC))
    bad["end_to_end"][0]["name"] = "rate per s"
    bad["end_to_end"][0]["unit"] = "tokens per second"
    assert len(check_names(bad)) == 2


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(name):
    cell = load_cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert reader_path(m["name"]).exists(), m["name"]
    assert cell.traffic["loop"] in ("eval", "train", "serve")


def test_metrics_move_an_end_to_end_metric_and_bounds_are_in_range():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25


def test_config_files_lie_under_paths():
    for c in SPEC["configs"]:
        path = ROOT / c["file"]
        assert path.exists() and c["file"].startswith(tuple(SPEC["paths"]))


def test_forbidden_modules_compare_whole_top_level_names():
    assert env.forbidden_modules(["dcl_net_tpu_torch", "dcl_net_tpu_torch.ops", "numpy"]) == []
    assert env.forbidden_modules(["dcl_net_tpu.models.dcl_net"]) == ["dcl_net_tpu"]
    assert env.forbidden_modules(["jax.numpy", "flax", "jaxlib.xla_client"]) == [
        "flax", "jax", "jaxlib"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"dcl_net_tpu_torch", "dcl_net_tpu", "jax", "flax"}, path


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(env.FORBIDDEN), path


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure it")
    out = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_result_line_keys_and_checks_last():
    sys.path.insert(0, str(BENCH_DIR))
    import run

    line = run.result_line(True, 10, 0, {"setup_s": {"value": 1.0, "unit": "s"}},
                           {"platform": "gpu"}, None, {"x": {"value": 1e-7, "limit": 1e-6}})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    line = run.result_line(False, 10, 1, {}, {}, {"device_ops": [], "idle_gaps": []},
                           {"x": {"value": 1.0, "limit": 1e-6}})
    assert list(line)[-2:] == ["breakdown", "checks"]

"""The benchmark's files, on the CPU: every cell of BENCHMARK.json finds
its configuration, traffic mix, runner and metric readers by name; names
keep to the allowed characters; no module of the benchmark loads JAX or
the JAX package, and the reference and the generator import nothing of
the program."""

import ast
import json
import re
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
JAX = {"jax", "jaxlib", "flax", "snark_bn254_verifier_tpu"}
PORT = "snark_bn254_verifier_tpu_torch"
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def imports(path: Path) -> set:
    """Top-level names of the modules ``path`` imports (absolute imports)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_names_existing_files(cell):
    configs = {c["name"]: c for c in BENCH["configs"]}
    cfg = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    assert cfg["name"] == cell["config"]
    assert (HERE / "reference" / f"{cfg['protocol']}.py").exists()
    assert (HERE / "gen" / f"{cfg['protocol']}.py").exists()
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (HERE / "runners" / f"{traffic['runner']}.py").exists()
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_has_a_reader_and_a_good_name(metric):
    assert (HERE / "metrics" / f"{metric['name']}.py").exists()
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_names_its_cells(metric):
    """BENCHMARK.json alone decides where a per-layer metric is read: each
    lists its cells, and each of them reports the metric it moves."""
    assert metric["workloads"]
    moves = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    assert set(metric["workloads"]) <= set(moves.get("workloads", metric["workloads"]))


def test_names_and_bounds():
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert NAME.match(entry["name"])
    for cell in BENCH["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["verify_bench"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_every_cell_reports_enough(cell):
    def here(m):
        return cell["name"] in m.get("workloads", [cell["name"]])

    e2e = {m["name"] for m in BENCH["end_to_end"] if here(m)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in m["workloads"] and m["moves"] in e2e
               for m in BENCH["per_layer"])


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: p.name)
def test_no_module_loads_jax_or_the_jax_package(path):
    assert not imports(path) & JAX


@pytest.mark.parametrize("sub", ["reference", "gen"])
def test_reference_and_generator_import_nothing_of_the_program(sub):
    for path in sorted((HERE / sub).glob("*.py")):
        assert PORT not in imports(path), path.name
        assert PORT not in path.read_text(), path.name


def test_the_run_names_jax_or_the_jax_package_once_loaded(monkeypatch):
    import types

    from verify_bench import run

    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "snark_bn254_verifier_tpu.ops",
                        types.ModuleType("snark_bn254_verifier_tpu.ops"))
    monkeypatch.setitem(sys.modules, "snark_bn254_verifier_tpu_torch_x",
                        types.ModuleType("snark_bn254_verifier_tpu_torch_x"))
    assert run.forbidden_modules() == ["jax", "snark_bn254_verifier_tpu"]

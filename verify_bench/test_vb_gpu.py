"""Each cell run for a short window on the card, through the program
itself, must come out correct and report its metrics. Marked ``gpu``:
skipped where there is no CUDA device. On a machine with one:

    python3 -m pytest --noconftest verify_bench/test_vb_gpu.py -m gpu -q
"""

import json
from pathlib import Path

import pytest

from verify_bench import run

ROOT = Path(__file__).resolve().parent.parent
CELLS = [c["name"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(cuda, name, trace):
    cell, cfg, traffic, metrics = run.load_cell(ROOT, name)
    got = run.run_cell(cell, cfg, traffic, metrics, 2**31 + 7, 2.0, trace)
    assert got["correct"], got["checks"]
    want = {m["name"] for m in metrics[1 if trace else 0]}
    assert set(got["metrics"]) == want
    if trace:
        assert 0 < got["device"]["busy_s"] <= got["device"]["window_s"]

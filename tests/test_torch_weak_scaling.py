"""The port's weak-scaling module (snark_bn254_verifier_tpu_torch/
weak_scaling.py), the counterpart of the JAX package's
tools/weak_scaling_child.py: 1 and 2 gloo processes on the CPU at a batch
of 2 a rank, each verifying its shard of the lanes; the line has the JAX
bench's metric name and fields, and its efficiencies are computed from
its points as the JAX bench computes them (bench.py:555-569). Without a
card the module's default, a process a card, raises rather than falling
back to the CPU."""

import os

import pytest
import torch

from snark_bn254_verifier_tpu_torch import bench, weak_scaling


@pytest.fixture(scope="module")
def line():
    return weak_scaling.run(per_rank=2, iters=1, ranks=(1, 2), device="cpu")


def test_points(line):
    assert [p["devices"] for p in line["points"]] == [1, 2]
    assert [p["batch"] for p in line["points"]] == [2, 4]
    assert all(p["iters"] == 1 and p["proofs_per_sec"] > 0 for p in line["points"])


def test_line_fields(line):
    assert line["metric"] == "weak_scaling_efficiency_8dev"
    assert line["platform"] == "cpu" and line["per_device_batch"] == 2
    assert "64" in line["per_device_batch_note"] and "points_note" not in line
    assert line["value"] == line["efficiency_vs_core_ceiling"]["2"]
    assert "cards" not in line and "cores" in line["unit"]


def test_efficiencies_as_the_jax_bench(line):
    base = line["points"][0]["proofs_per_sec"]
    cores = os.cpu_count() or 1
    assert line["host_cores"] == cores
    for p in line["points"]:
        n = p["devices"]
        assert line["efficiency"][str(n)] == round(p["proofs_per_sec"] / (n * base), 4)
        assert line["efficiency_vs_core_ceiling"][str(n)] == round(
            p["proofs_per_sec"] / (min(n, cores) * base), 4)
    assert line["efficiency"]["1"] == 1.0


def test_the_default_is_the_card(monkeypatch):
    """No card: the default device raises at once and starts no process."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(weak_scaling, "point", lambda *a, **k: pytest.fail("a rank started"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weak_scaling.run()


def test_the_bench_config_scales_over_its_device(monkeypatch):
    """The bench's ``scaling`` passes its device and batch: the CPU's 16
    lanes a rank, the card's bench batch; the card's fields only on it."""
    seen = []
    monkeypatch.setattr(weak_scaling, "run",
                        lambda per_rank, iters, device: seen.append((per_rank, iters, device))
                        or {"metric": "weak_scaling_efficiency_8dev", "platform": device})
    cpu = bench.bench_scaling(bench.Run(device="cpu", batch_size=4, iters=8))
    card = bench.bench_scaling(bench.Run(device="cuda", iters=2, card={"gpu": "H100"}))
    assert seen == [(16, 4, "cpu"), (1024, 2, "cuda")]
    assert cpu == {"metric": "weak_scaling_efficiency_8dev", "platform": "cpu"}
    assert card["platform"] == "cuda" and card["gpu"] == "H100"

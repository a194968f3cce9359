"""The port's bench (snark_bn254_verifier_tpu_torch/bench.py) on the CPU:
``bench.main`` with ``--device cpu`` at tiny sizes (batch 2, 1 iteration,
2 for the Groth16 batch, 2^6 MSM points) prints one JSON line a config under the JAX bench's
metric name, with its fields; the batch lines' stats come from the timed
batches, not the warm-up; a failing config prints an error line and the
run exits non-zero; without a card and without ``--device`` the bench
exits non-zero at once; the kernel_validation coverage map is
KERNEL_ENTRY_POINTS; the flags keep the JAX bench's defaults.

Slow (each a minute or more of plain twins on one core): plonk_batch,
mixed, groth16_single and plonk_single. The weak-scaling module has its
own file (tests/test_torch_weak_scaling.py)."""

import json

import pytest
import torch

from snark_bn254_verifier_tpu_torch import KERNEL_ENTRY_POINTS, bench
from snark_bn254_verifier_tpu_torch.parallel import batch
from torch_host_build import one_torch_thread  # noqa: F401 (autouse)

# The JAX bench's metric names (bench.py:124,174,295,347,221,241,574), and
# kernel_validation in the place of its pallas_validation preflight (:518).
JAX_METRICS = {
    "groth16_batch": "groth16_batched_verify_throughput",
    "plonk_batch": "plonk_batched_verify_throughput",
    "msm": "msm_2e6_sharded_wallclock",
    "mixed": "mixed_groth16_plonk_throughput",
    "groth16_single": "groth16_single_verify_latency",
    "plonk_single": "plonk_single_verify_latency",
    "scaling": "weak_scaling_efficiency_8dev",
    "kernel_validation": "kernel_validation",
}
TINY = ["--device", "cpu", "--batch", "2", "--iters", "1", "--msm-log2n", "6"]
FIELDS = {
    "groth16_batch": {"value", "unit", "batch", "iters", "chips", "pairings_per_sec",
                      "pairings_per_proof", "host_stage_s", "stats_batches", "mults_per_proof",
                      "mont_mults_per_sec", "pct_imad_roofline", "warmup_s"},
    "plonk_batch": {"value", "unit", "batch", "iters", "vector", "pairings_per_sec",
                    "host_stage_s", "mults_per_proof", "pct_imad_roofline"},
    "msm": {"value", "unit", "points", "window_bits", "points_per_sec", "chips", "fp_muls",
            "bound_ms", "bound_by"},
    "mixed": {"value", "unit", "batch", "iters", "vector", "host_stage_s"},
    "groth16_single": {"value", "unit", "iters"},
    "plonk_single": {"value", "unit", "iters", "vector"},
    "kernel_validation": {"value", "unit", "stages"},
}


def run_bench(capsys, *args):
    """(rc, every stdout line parsed) of bench.main(args)."""
    rc = bench.main(list(args))
    return rc, [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def check_line(name, line):
    assert "error" not in line, line
    assert line["metric"] == JAX_METRICS[name] and line["platform"] == "cpu"
    assert FIELDS[name] <= set(line), FIELDS[name] - set(line)
    assert "vs_baseline" not in line


class Numbered(batch.Groth16BatchVerifier):
    """Numbers each call's ``last_stats``: its host stage seconds become
    the call's number, so a line's ``host_stage_s`` tells which calls it
    read (1 is the warm-up's)."""

    calls = 0

    def _numbered(self):
        Numbered.calls += 1
        self.last_stats.extra["host_s"] = float(Numbered.calls)

    def verify_batch(self, *args, **kw):
        out = super().verify_batch(*args, **kw)
        self._numbered()
        return out

    def verify_batch_async(self, *args, **kw):
        out = super().verify_batch_async(*args, **kw)
        self._numbered()
        return out


@pytest.fixture(scope="module")
def groth16_run():
    """The groth16_batch config once, its verifier numbering its stats:
    (rc, lines)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(batch, "Groth16BatchVerifier", Numbered)
    Numbered.calls = 0
    lines = []
    mp.setattr(bench, "emit", lines.append)
    try:
        rc = bench.main(TINY + ["--configs", "groth16_batch", "--iters", "2"])
    finally:
        mp.undo()
    return rc, lines


def test_groth16_batch_line(groth16_run):
    rc, lines = groth16_run
    assert rc == 0
    build, line = lines
    assert build == {"build_s": 0.0, "platform": "cpu"}
    check_line("groth16_batch", line)
    assert line["batch"] == 2 and line["iters"] == 2 and line["value"] > 0
    assert line["mults_per_proof"] == 50_866 and line["pairings_per_proof"] == 3
    pps = line["batch"] * line["iters"] / line["elapsed_s"]  # unrounded
    assert line["pairings_per_sec"] == pytest.approx(3 * pps, abs=0.06)


def test_batch_stats_come_from_the_timed_batches(groth16_run):
    """Call 1 is the warm-up's verify_batch; calls 2 and 3 the timed
    loop's verify_batch_async: the line reads their mean. Call 4 is the
    lane count's, on the CPU after the loop."""
    _, (_, line) = groth16_run
    assert Numbered.calls == 4
    assert line["stats_batches"] == 2 and line["host_stage_s"] == 2.5


def test_msm_line(capsys):
    rc, (_, line) = run_bench(capsys, *TINY, "--configs", "msm")
    assert rc == 0
    check_line("msm", line)
    assert line["points"] == 64 and line["window_bits"] == 8 and line["iters"] == 2
    assert line["bound_by"] == "operations" and line["fp_muls"] > 64 * 11  # a madd a digit


def test_kernel_validation_line_on_the_cpu(capsys):
    rc, (_, line) = run_bench(capsys, *TINY, "--configs", "kernel_validation")
    assert rc == 0
    check_line("kernel_validation", line)
    assert line["value"] == 1 and line["kernels"] == "plain twins"
    assert set(line["stages"]) == set(bench.KERNEL_VALIDATION_COVERAGE) | {"coverage"}
    assert all(stage["ok"] for stage in line["stages"].values())


@pytest.mark.slow  # plain twins: about a minute a config on one core
@pytest.mark.parametrize("name", ["plonk_batch", "mixed", "groth16_single", "plonk_single"])
def test_slow_config_lines(capsys, name):
    rc, (_, line) = run_bench(capsys, *TINY, "--configs", name)
    assert rc == 0
    check_line(name, line)


def test_coverage_map_is_the_kernel_registry():
    covered = set().union(*bench.KERNEL_VALIDATION_COVERAGE.values())
    assert covered == set(KERNEL_ENTRY_POINTS)


def test_configs_and_metrics_are_the_jax_benchs():
    assert bench.ORDER == list(JAX_METRICS)
    assert {k: v.format(log2n=6) for k, v in bench.METRICS.items()} == JAX_METRICS
    assert set(bench.RUNNERS) == set(bench.BUDGETS) == set(JAX_METRICS)


def fake_runner(name, seen):
    def run(r):
        seen.append((name, r))
        return r.line(name, value=1.0, unit="x")
    return run


def test_a_failing_config_gives_an_error_line_and_rc_1(capsys, monkeypatch):
    """The headline runs first whatever the order asked, is printed again
    last, and a failing config does not stop the others."""
    seen = []

    def boom(r):
        raise ValueError("forced")

    monkeypatch.setattr(bench, "RUNNERS", {**bench.RUNNERS, "msm": boom,
                                           "groth16_batch": fake_runner("groth16_batch", seen),
                                           "plonk_single": fake_runner("plonk_single", seen)})
    rc, lines = run_bench(capsys, *TINY, "--configs", "msm,plonk_single,groth16_batch")
    assert rc == 1
    build, g16, err, single, again = lines
    assert g16["metric"] == JAX_METRICS["groth16_batch"] and again == g16
    assert err["metric"] == JAX_METRICS["msm"] and err["error"] == "ValueError: forced"
    assert single["metric"] == JAX_METRICS["plonk_single"] and "error" not in single
    assert [n for n, _ in seen] == ["groth16_batch", "plonk_single"]


def test_a_failed_validation_exits_1(capsys, monkeypatch):
    monkeypatch.setattr(bench, "RUNNERS", {**bench.RUNNERS, "kernel_validation":
                                           lambda r: r.line("kernel_validation", value=0,
                                                            unit="ok")})
    rc, lines = run_bench(capsys, *TINY, "--configs", "kernel_validation")
    assert rc == 1 and lines[-1]["value"] == 0


def test_without_a_card_the_bench_exits_at_once(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(bench, "RUNNERS", {k: fake_runner(k, called) for k in bench.RUNNERS})
    rc, lines = run_bench(capsys)
    assert rc != 0 and lines == [] and called == []


@pytest.mark.parametrize("args,want", [
    ([], (1024, 8, 16, 8)),
    (["--smoke"], (32, 2, 10, 8)),
    (["--smoke", "--batch", "4", "--iters", "3", "--msm-log2n", "7", "--msm-c", "6"],
     (4, 3, 7, 6)),
])
def test_flags_keep_the_jax_defaults(capsys, monkeypatch, args, want):
    seen = []
    monkeypatch.setattr(bench, "RUNNERS", {k: fake_runner(k, seen) for k in bench.RUNNERS})
    rc, _ = run_bench(capsys, "--device", "cpu", "--configs", "msm", *args)
    assert rc == 0
    (_, r), = seen
    assert (r.batch_size, r.iters, r.log2n, r.msm_window_bits) == want and r.device == "cpu"

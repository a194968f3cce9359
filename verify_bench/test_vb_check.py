"""The comparison that decides ``correct``, on the CPU: a whole run of a
cell (pool, set-up, warm-up, window, check), with the harness's look for
a chip skipped and the plain reference standing in for the program. The
sound stand-in comes out correct; the control (the reference accepting
non-canonical encodings, a guarantee of both configurations) and every
fault the timed path can have (its state unchanged, half the batch left
out, verdicts dropped, one verdict altered where it is produced) come
out not correct. A cell on one chip has no exchange between chips to
leave out."""

import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

from verify_bench import run, standin
from verify_bench.gen.pool import make_pool

ROOT = Path(__file__).resolve().parent.parent
SEED = 2**31 + 101


def small(name):
    """The cell at a size a test holds: every fault kind in a small pool."""
    cell, cfg, traffic, metrics = run.load_cell(ROOT, name)
    traffic = dict(traffic, pool=24, bad_share=0.5, check_sample=14)
    if "batch" in traffic:
        traffic["batch"] = 24
    return cell, cfg, traffic, metrics


def one_run(name, **kw):
    cell, cfg, traffic, metrics = small(name)
    pool = make_pool(cfg, traffic, SEED)  # the run's own pool: the verdicts made beforehand
    system = standin.factory(traffic["runner"], SEED, pool=pool, **kw)
    return run.run_cell(cell, cfg, traffic, metrics, SEED, 0.5, False, system=system)


@pytest.mark.parametrize("name", ["groth16-sp1-b2048", "groth16-sp1-single",
                                  "plonk-sp1-b1024"])
def test_sound_stand_in_is_correct_and_control_is_not(name):
    sound = one_run(name)
    assert sound["correct"], sound["checks"]
    assert sound["failed"] == 0 and sound["attempted"] > 0
    assert set(sound["metrics"]) >= {"setup_s"}
    control = one_run(name, canonical=False)
    assert not control["correct"]
    assert control["checks"]["label_mismatch"]["value"] > 0
    assert control["checks"]["ref_mismatch"]["value"] > 0


@pytest.mark.parametrize("fault", standin.FAULTS)
@pytest.mark.parametrize("name", ["groth16-sp1-b2048", "groth16-sp1-single",
                                  "plonk-sp1-b1024"])
def test_every_fault_of_the_timed_path_is_not_correct(name, fault):
    got = one_run(name, fault=fault)
    assert not got["correct"], (fault, got["checks"])


def sync_loop(ver, pool, traffic, orders, tracer, seconds=0.0, count=0):
    """A runner's loop no file of the benchmark has: one batch at a time,
    its verdicts read before the next is sent."""
    rec = {"records": [], "latency_s": []}
    t0 = time.perf_counter()
    sent = 0
    while (sent < count) if count else (time.perf_counter() < t0 + seconds):
        idx = orders.batch(traffic["batch"])
        t = time.perf_counter()
        got = ver.verify_batch_async([pool.proofs[i] for i in idx],
                                     [pool.inputs[i] for i in idx])
        rec["latency_s"].append(time.perf_counter() - t)
        rec["records"].append((idx, np.asarray(got)))
        sent += 1
    rec["window_s"] = time.perf_counter() - t0
    rec["lanes"] = sent * traffic["batch"]
    return rec


def test_a_new_runner_is_read_with_no_reader_edited(monkeypatch):
    """A runner added under a new name reports the end-to-end metrics of
    the cell it serves through the readers as they stand, and a per-layer
    reader whose records that runner does not keep leaves its metric out."""
    name = "verify_bench.runners.sync_stand_in"
    mod = types.ModuleType(name)
    mod.WARMUP, mod.loop = 1, sync_loop
    monkeypatch.setitem(sys.modules, name, mod)
    cell, cfg, traffic, metrics = small("groth16-sp1-b2048")
    traffic = dict(traffic, runner="sync_stand_in")
    pool = make_pool(cfg, traffic, SEED)
    got = run.run_cell(cell, cfg, traffic, metrics, SEED, 0.5, False,
                       system=standin.factory("batch_async", SEED, pool=pool))
    assert got["correct"], got["checks"]
    assert set(got["metrics"]) == {m["name"] for m in metrics[0]}
    assert {"proofs_per_s", "batch_p95_ms", "setup_s"} <= set(got["metrics"])
    rec = {"records": [], "latency_s": [0.01], "lanes": 24, "window_s": 0.5,
           "setup_s": 1.0, "products_per_proof": cfg["products_per_proof"]}
    assert all(run.reader(m["name"])(rec) is None for m in metrics[1])

"""Run one cell of the port's benchmark once.

    python3 -m verify_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout of the repository, on a machine with the
NVIDIA GPUs the cell asks for. The cell is the entry of ``workloads`` in
BENCHMARK.json with that name; it names a configuration (its file under
verify_bench/configs/) and a traffic mix (verify_bench/traffic/<name>.json),
which names its runner (verify_bench/runners/<runner>.py). Each metric
the cell reports is read by verify_bench/metrics/<metric>.py: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones, from a torch.profiler trace of the window. So a new
configuration, mix, runner or metric is new files and a new entry, and
no edit.

A run: the pool of proofs from the seed, the program's verifier, warm-up
calls (set-up ends there), the window of ``--seconds``, then the
comparison with the plain reference (verify_bench/check.py). The last
line of standard output is one JSON object: ``correct``, ``attempted``
(proofs sent in the window), ``failed`` (proofs whose verdict was wrong
or missing), ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``, each compared number beside its limit; the same
numbers end standard error. Keys the driver does not read say where the
set-up went, the latencies' spread, the card's power limit and clock,
and what the reference checked. Without a CUDA device, with fewer than the
cell's chips, or with JAX or the JAX package loaded once the window has
closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# Top-level module names that must not be loaded in the measured process:
# JAX and the JAX package (compared whole: the port's name starts with it).
FORBIDDEN = ("jax", "jaxlib", "flax", "snark_bn254_verifier_tpu")


class Refused(Exception):
    """The run cannot give a result; the message says why."""


def load_cell(root: Path, name: str):
    """(cell, its configuration, its traffic mix, its metrics) from
    BENCHMARK.json: the metrics are (end_to_end, per_layer) entries that
    this cell reports: an end-to-end metric where its ``workloads`` name
    the cell or it has none, a per-layer one where its ``workloads`` (which
    every per-layer entry has) name the cell."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())

    def here(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if here(m)]
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return cell, cfg, traffic, (e2e, layer)


def reader(metric: str):
    """verify_bench/metrics/<metric>.py's ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"verify_bench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_state() -> dict:
    """The card's name, power limit and SM clock, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": f"unavailable: {e}"}
    return {"nvidia_smi": out.strip().splitlines()}


def run_cell(cell: dict, cfg: dict, traffic: dict, metrics, seed: int, seconds: float,
             trace: bool, system=None, t_start: float = None) -> dict:
    """One run of ``cell``; ``system(cfg, vk)`` stands in for the runner's
    program where given. Returns the result's object."""
    import numpy as np
    import torch

    from . import check
    from . import trace as tr
    from .gen.pool import Orders, make_pool

    cuda = torch.cuda.is_available()
    t_start = T_START if t_start is None else t_start
    runner = importlib.import_module(f"{__package__}.runners.{traffic['runner']}")
    laps = [time.perf_counter()]
    pool = make_pool(cfg, traffic, seed)
    orders = Orders(len(pool.proofs), seed)
    laps.append(time.perf_counter())
    program = (system or runner.system)(cfg, pool.vk)
    laps.append(time.perf_counter())
    runner.loop(program, pool, traffic, orders, tr.Tracer(False), count=runner.WARMUP)
    if cuda:
        torch.cuda.synchronize()
    laps.append(time.perf_counter())
    setup_s = laps[-1] - t_start

    tracer = tr.Tracer(trace)
    with tracer.window():
        rec = runner.loop(program, pool, traffic, orders, tracer, seconds=seconds)
    if cuda:
        torch.cuda.synchronize()
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell["chips"],
              "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    rec.update(setup_s=setup_s, products_per_proof=cfg["products_per_proof"])
    out_extra = {}
    if trace:
        t = tr.read(tracer.prof)
        tracer.prof = None
        rec["trace"] = tr.reduce(t)
        device.update(busy_s=rec["trace"]["busy_us"] / 1e6,
                      window_s=rec["trace"]["window_us"] / 1e6)
        out_extra["breakdown"] = tr.breakdown(t)
    del program
    if cuda:
        torch.cuda.empty_cache()

    judged = check.judge(cfg, traffic, pool, rec["records"], seed)
    numbers = judged["numbers"]
    values = {}
    for m in metrics[1 if trace else 0]:
        v = reader(m["name"])(rec)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    failed = numbers["label_mismatch"][0] + numbers["missing"][0]
    lat = rec["latency_s"]
    return {"correct": check.correct(judged), "attempted": int(rec["lanes"]),
            "failed": int(failed), "metrics": values, "device": device, **out_extra,
            "card": card_state() if cuda else {},
            "setup": {"imports_s": laps[0] - t_start, "pool_s": laps[1] - laps[0],
                      "program_s": laps[2] - laps[1], "warmup_s": laps[3] - laps[2]},
            "window": {"seconds": rec["window_s"], "calls": len(lat),
                       "latency_ms": {f"p{q}": float(np.percentile(lat, q)) * 1e3
                                      for q in (50, 90, 95, 99, 100)}},
            "reference": {"seconds": judged["reference_s"], "compared": judged["ref_compared"]},
            "raised": rec.get("raised", {}),
            "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell, cfg, traffic, metrics = load_cell(Path.cwd(), args.workload)
        import torch

        if not torch.cuda.is_available():
            raise Refused("no CUDA device")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{torch.cuda.device_count()} CUDA devices, the cell needs "
                          f"{cell['chips']}")
        result = run_cell(cell, cfg, traffic, metrics, args.seed, args.seconds,
                          bool(args.trace))
        loaded = forbidden_modules()
        if loaded:
            raise Refused(f"loaded in the measured process: {', '.join(loaded)}")
    except (Refused, ImportError, FileNotFoundError) as e:
        print(f"verify_bench: no result: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark of the PyTorch/CUDA port: the JAX package's bench configs and
metric names, on one NVIDIA GPU.

    python3 -m snark_bn254_verifier_tpu_torch.bench [--smoke] [--batch N]
        [--iters K] [--configs a,b,...|all] [--msm-c BITS] [--msm-log2n N]
        [--device cuda|cpu]

The counterpart of the repository's bench.py (the JAX package's): the
same configs, flags, defaults (batch 1024, 8 iterations, 2^16 MSM points
at c = 8; --smoke: 32, 2, 2^10) and metric names, one JSON line a config.
The headline, batched Groth16 throughput, runs first and its line is
printed again last. Measured numbers are printed unrounded.

  groth16_batch      groth16_batched_verify_throughput   [headline]
  plonk_batch        plonk_batched_verify_throughput
  msm                msm_2e<N>_sharded_wallclock (sharded_msm, world size 1)
  mixed              mixed_groth16_plonk_throughput
  groth16_single     groth16_single_verify_latency
  plonk_single       plonk_single_verify_latency
  scaling            weak_scaling_efficiency_8dev (weak_scaling.py: a
                     process a card, 1 to 8 as the machine has them)
  kernel_validation  kernel_validation (every KERNEL_ENTRY_POINTS entry
                     exact against its plain twin, on the card)

It runs on the card; ``--device cpu`` is the one way to run it on the
CPU (the plain twins), and without a card it exits non-zero at once. The
kernels are built before any timing (the ``build_s`` line). Every line
carries the platform, the card's name and power limit (nvidia-smi), and,
for the batch configs, the roofline fields of utils/roofline.py (the H100
model; ``pct_imad_roofline_computed`` is the card's share of its peak,
``pct_imad_roofline`` counts as the JAX package counts) and stats taken
from the timed batches (``last_stats`` after each
timed call; the JAX bench reads the warm-up's). There is no
``vs_baseline``: its target is a TPU chip's.

The batch configs are pipelined through ``verify_batch_async``, at most
two batches in flight, as the JAX bench does. Each config runs under the
JAX bench's fault isolation and wall-clock budget: a failing config
prints an error line and the others go on, but the run then exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import statistics
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

from .utils.config import VerifierConfig

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = "/root/reference/examples/binaries"
PLONK_VK = os.path.join(PKG_DIR, "fixtures", "plonk_vk.bin")
MSM_SEED = 11  # the JAX bench's trapdoor seed (bench.py:262)

ORDER = ["groth16_batch", "plonk_batch", "msm", "mixed", "groth16_single", "plonk_single",
         "scaling", "kernel_validation"]
METRICS = {
    "groth16_batch": "groth16_batched_verify_throughput",
    "plonk_batch": "plonk_batched_verify_throughput",
    "msm": "msm_2e{log2n}_sharded_wallclock",
    "mixed": "mixed_groth16_plonk_throughput",
    "groth16_single": "groth16_single_verify_latency",
    "plonk_single": "plonk_single_verify_latency",
    "scaling": "weak_scaling_efficiency_8dev",
    "kernel_validation": "kernel_validation",
}
# Wall-clock budgets (seconds) of the JAX bench, and its global budget.
BUDGETS = {"groth16_batch": 1300, "plonk_batch": 900, "msm": 900, "mixed": 480,
           "groth16_single": 300, "plonk_single": 420, "scaling": 900,
           "kernel_validation": 900}
GLOBAL_BUDGET_S = int(os.environ.get("BN254_TORCH_BENCH_BUDGET_S", "3300"))

# Which kernel entry points each kernel_validation stage holds against
# its plain twin; their union must be ops/pairing_cuda.py::
# KERNEL_ENTRY_POINTS (checked by the stage and by tests/test_torch_bench.py),
# so a new kernel cannot ship unvalidated.
KERNEL_VALIDATION_COVERAGE = {
    "mont_mul": ("mont_mul",),
    "g2_on_curve": ("g2_on_curve",),
    "msm": ("msm_affine", "msm_pippenger"),
    "miller_final_exp": ("miller_product", "final_exp"),
    "miller_mixed_var": ("miller_mixed", "final_exp"),
    "miller_mixed_fixed_only": ("miller_mixed",),
}


@dataclass
class Run(VerifierConfig):
    """What every config reads: the verifier configuration (``batch_size``,
    ``msm_window_bits``), as the JAX bench's ``cfg``, and the device, the
    timed iterations, the MSM size and the card's fields."""

    batch_size: int = 1024
    msm_window_bits: int = 8
    device: str = "cuda"
    iters: int = 8
    log2n: int = 16
    card: dict = field(default_factory=dict)

    def line(self, name: str, **fields) -> dict:
        return {"metric": METRICS[name].format(log2n=self.log2n), **fields,
                "platform": self.device, **self.card}


def card_fields(device: str) -> dict:
    """The card's name and power limit as nvidia-smi gives them."""
    if device != "cuda":
        return {}
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    name, limit = out.strip().splitlines()[0].rsplit(",", 1)
    return {"gpu": name.strip(), "power_limit": limit.strip()}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def plonk_vector():
    """(vk_bytes, proof_bytes, public_inputs, source): the golden SP1
    fibonacci vector where the reference checkout is present, the
    synthetic BSB22 vector otherwise."""
    if os.path.isdir(GOLDEN_DIR):
        from .utils.sp1_wrapper import load_sp1_wrapper

        w = load_sp1_wrapper(os.path.join(GOLDEN_DIR, "fibonacci_plonk_proof.bin"))
        with open(PLONK_VK, "rb") as f:
            return f.read(), w.raw_proof, list(w.public_inputs), "golden"
    from .fixtures.gen import gen_plonk_vector

    v = gen_plonk_vector(0)
    return v.vk, v.proof, list(v.public_inputs), "synthetic"


def pipelined(dispatches, iters: int):
    """``iters`` rounds of ``dispatches`` ((verify_batch_async call, its
    verifier) pairs), at most two batches in flight, every bool checked
    True. Returns (seconds, the ``last_stats`` each dispatch left)."""
    pending, stats = [], []
    t0 = time.perf_counter()
    for _ in range(iters):
        for dispatch, ver in dispatches:
            pending.append(dispatch())
            stats.append(ver.last_stats)
            while len(pending) > 2:
                _require(bool(pending.pop(0).cpu().all()), "a pipelined batch failed")
    for ok in pending:
        _require(bool(ok.cpu().all()), "a pipelined batch failed")
    return time.perf_counter() - t0, stats


def timed_stats(stats) -> dict:
    """The line's stats, from the timed batches' ``last_stats``."""
    return {"pairings_per_proof": stats[-1].pairings_per_proof,
            "host_stage_s": statistics.fmean(s.extra["host_s"] for s in stats),
            "stats_batches": len(stats)}


def _batch_config(run: Run, name: str, verifier, vk: bytes, proofs, inputs, mults: int,
                  **fields):
    """Warm-up (set-up, the first batch checked), then the pipelined timed
    loop; the line with its roofline fields, the computed count of one
    lane taken after the loop on the plain twins."""
    from .utils import roofline as RL

    t0 = time.perf_counter()
    ok = verifier.verify_batch(proofs, inputs)
    warm_s = time.perf_counter() - t0
    _require(bool(ok.all()), f"{name}: the warm-up batch did not verify")
    elapsed, stats = pipelined([(lambda: verifier.verify_batch_async(proofs, inputs),
                                 verifier)], run.iters)
    pps = run.batch_size * run.iters / elapsed
    st = timed_stats(stats)
    line = run.line(name, value=pps, unit="proofs/sec/chip", batch=run.batch_size,
                    iters=run.iters, chips=1, **fields, warmup_s=warm_s, elapsed_s=elapsed,
                    pairings_per_sec=pps * st["pairings_per_proof"], **st)
    line.update(RL.roofline_fields(pps, mults, RL.lane_mults(
        type(verifier), vk, proofs[0], inputs[0])))
    return line


def bench_groth16_batch(run: Run) -> dict:
    from .fixtures.gen import gen_groth16_vector
    from .parallel.batch import Groth16BatchVerifier
    from .utils import roofline as RL

    vec = gen_groth16_vector(0, num_inputs=2)
    ver = Groth16BatchVerifier(vec.vk, device=run.device)
    return _batch_config(run, "groth16_batch", ver, vec.vk, [vec.proof] * run.batch_size,
                         [vec.public_inputs] * run.batch_size,
                         RL.groth16_mults_per_proof(ver.n_inputs))


def bench_plonk_batch(run: Run) -> dict:
    from .parallel.batch import PlonkBatchVerifier
    from .utils import roofline as RL

    vk, proof, inputs, source = plonk_vector()
    ver = PlonkBatchVerifier(vk, device=run.device)
    return _batch_config(run, "plonk_batch", ver, vk, [proof] * run.batch_size,
                         [inputs] * run.batch_size, RL.plonk_mults_per_proof(len(ver.vk.qcp)),
                         vector=source)


def bench_mixed(run: Run) -> dict:
    """Half a batch of each protocol, interleaved, at most two in flight."""
    from .fixtures.gen import gen_groth16_vector
    from .parallel.batch import Groth16BatchVerifier, PlonkBatchVerifier

    half = run.batch_size // 2
    iters = max(2, run.iters // 2)
    g = gen_groth16_vector(0, num_inputs=2)
    vk, proof, inputs, source = plonk_vector()
    gv, pv = Groth16BatchVerifier(g.vk, device=run.device), PlonkBatchVerifier(vk, device=run.device)
    g_args, p_args = ([g.proof] * half, [g.public_inputs] * half), ([proof] * half, [inputs] * half)
    t0 = time.perf_counter()
    ok = gv.verify_batch(*g_args).all() and pv.verify_batch(*p_args).all()
    warm_s = time.perf_counter() - t0
    _require(bool(ok), "mixed: a warm-up batch did not verify")
    elapsed, stats = pipelined([(lambda: gv.verify_batch_async(*g_args), gv),
                                (lambda: pv.verify_batch_async(*p_args), pv)],
                               iters)
    pps = 2 * half * iters / elapsed
    return run.line("mixed", value=pps, unit="proofs/sec/chip", batch=2 * half,
                    iters=iters, chips=1, vector=source, warmup_s=warm_s, elapsed_s=elapsed,
                    host_stage_s=statistics.fmean(s.extra["host_s"] for s in stats),
                    stats_batches=len(stats))


def _latency(fn, iters: int) -> float:
    """Median seconds of ``iters`` warm calls, each True."""
    _require(fn() is True, "the warm-up call did not verify")
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _require(fn() is True, "a timed call did not verify")
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def bench_groth16_single(run: Run) -> dict:
    from .fixtures.gen import gen_groth16_vector
    from .models.groth16 import Groth16Verifier

    iters = max(4, run.iters)
    vec = gen_groth16_vector(0, num_inputs=2)
    med = _latency(lambda: Groth16Verifier.verify(vec.proof, vec.vk, vec.public_inputs,
                                                  device=run.device), iters)
    return run.line("groth16_single", value=med * 1e3, unit="ms", iters=iters)


def bench_plonk_single(run: Run) -> dict:
    from .models.plonk import PlonkVerifier

    iters = max(4, run.iters)
    vk, proof, inputs, source = plonk_vector()
    med = _latency(lambda: PlonkVerifier.verify(proof, vk, inputs, device=run.device), iters)
    return run.line("plonk_single", value=med * 1e3, unit="ms", iters=iters,
                    vector=source)


def bench_msm(run: Run) -> dict:
    """sharded_msm on 2^log2n trapdoor points (the JAX bench's data, seed
    11) over a world-size-1 group (NCCL on the card, gloo on the CPU),
    exact against the closed form; host clock, synchronised. Beside it
    the bound of the bucket method's work on these inputs
    (utils/roofline.py::pippenger_work), the kernel table's bound for K6."""
    import torch
    import torch.distributed as dist

    from .utils import roofline as RL

    from .fixtures.msm_lanes import trapdoor_msm
    from .models.packing import pack_msm, unpack_g1
    from .parallel.sharded import free_port, init_distributed, make_mesh, sharded_msm

    n = 1 << run.log2n
    iters = max(2, run.iters // 2)
    pts, scs, expected = trapdoor_msm(n, MSM_SEED)
    packed, sc = pack_msm(pts, scs)
    points = tuple(torch.as_tensor(a, device=run.device) for a in packed)
    scal = torch.as_tensor(sc, device=run.device)
    owner = not dist.is_initialized()
    init_distributed(init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0,
                     device=run.device)
    try:
        mesh = make_mesh(1, model_parallelism=1, device=run.device)
        t0 = time.perf_counter()
        out = sharded_msm(mesh, points, scal, c=run.msm_window_bits)
        _require(unpack_g1(*out)[0] == expected, "sharded MSM != the closed form")
        warm_s = time.perf_counter() - t0
        times = []
        for _ in range(iters):
            _sync(run.device)
            t0 = time.perf_counter()
            sharded_msm(mesh, points, scal, c=run.msm_window_bits)
            _sync(run.device)
            times.append(time.perf_counter() - t0)
    finally:
        if owner:
            dist.destroy_process_group()
    per_msm = statistics.fmean(times)
    nbytes = sum(t.numel() * t.element_size() for t in (*points, scal, *out))
    bnd = RL.bound(RL.pippenger_work(points, scal, run.msm_window_bits), nbytes)
    return run.line("msm", value=per_msm * 1e3, unit="ms", points=n,
                    window_bits=run.msm_window_bits, points_per_sec=n / per_msm, chips=1,
                    iters=iters, median_ms=statistics.median(times) * 1e3, warmup_s=warm_s,
                    fp_muls=bnd["fp_muls"], bound_ms=bnd["bound_ms"],
                    bound_by=bnd["bound_by"])


def bench_scaling(run: Run) -> dict:
    """weak_scaling.py on the machine's cards (the bench's batch a rank),
    or its cores with --device cpu."""
    from . import weak_scaling

    per_rank = run.batch_size if run.device == "cuda" else weak_scaling.PER_RANK_CPU
    line = weak_scaling.run(per_rank, max(2, run.iters // 2), device=run.device)
    return {**line, **run.card}


def _same(a, b) -> bool:
    """Tensors (or nested tuples of them) equal, limb for limb."""
    import torch

    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b.to(a.device))


def _kernel_stages(device: str, b: int) -> dict:
    """The stages of kernel_validation on ``b`` lanes: each wrapper's
    output equal to its plain twin's on the same inputs (on the card; on
    the CPU the wrapper runs the twin), a few lanes equal to the oracle,
    and on the card each stage's kernels launched."""
    import random

    import numpy as np
    import torch

    from .models.packing import pack_g1, pack_g2, pair_major, unpack_fq12, unpack_g1
    from .ops import curve as C
    from .ops import field as F
    from .ops import field_cuda as FC
    from .ops import lines as LN
    from .ops import msm as M
    from .ops import pairing as PR
    from .ops import pairing_cuda as PC
    from .oracle import bn254 as bn
    from .fixtures.g2_lanes import g2_mask_lanes
    from .ops.limbs import FQ, FR, limbs_batch_to_ints

    rng = random.Random(17)
    on_card = device == "cuda"

    def dev(arrays):
        return tuple(torch.as_tensor(a, device=device) for a in arrays)

    def exact(got, twin) -> bool:
        return not on_card or _same(got, twin())

    def g1s(k):
        return [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(k)]

    def g2s(k):
        return [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(k)]

    def mont_mul():
        ok = True
        for spec in (FQ, FR):
            xs, ys = ([rng.randrange(spec.modulus) for _ in range(b)] for _ in range(2))
            a, c = dev((spec.pack(xs, mont=False), spec.pack(ys, mont=False)))
            got = FC.mont_mul(spec, a, c)
            ok &= exact(got, lambda: F.mont_mul(spec, a, c))
            ok &= limbs_batch_to_ints(got.cpu().numpy()) == [
                x * y * spec.r_inv % spec.modulus for x, y in zip(xs, ys)]
        return ok

    def g2_on_curve():
        x, y, inf, valid, want = g2_mask_lanes(17, b, head=("on", "off", "inf", "invalid"))
        bs, tvalid = dev((x, y, inf)), torch.as_tensor(valid, device=device)
        got = PC.g2_on_curve(bs, tvalid)
        return exact(got, lambda: C.g2_on_curve(bs, tvalid)) and got.cpu().tolist() == want

    def msm():
        n = 3
        pts = [g1s(b) for _ in range(n)]
        pts[1][0] = None  # a point at infinity
        scs = [[rng.randrange(bn.R) for _ in range(b)] for _ in range(n)]
        scs[0][b - 1] = 0
        packed = [pack_g1(p) for p in pts]
        points = dev(tuple(np.stack([p[i] for p in packed]) for i in range(3)))
        sc = torch.as_tensor(np.stack([FR.pack(s, mont=False) for s in scs]),
                             device=device)
        k2, k6 = PC.msm_affine(points, sc), PC.msm_pippenger(points, sc)
        want = [bn.g1_msm([pts[j][lane] for j in range(n) if pts[j][lane] is not None],
                          [scs[j][lane] for j in range(n) if pts[j][lane] is not None])
                for lane in range(b)]
        return (exact(k2, lambda: C.msm_affine(points, sc))
                and exact(k6, lambda: M.pippenger_plain(points, sc))
                and _same(k2, k6) and unpack_g1(*k2) == want)

    def check_gt(f, twin_f, pairs, final_exp_twin=False) -> bool:
        """The Miller value exact against its twin, its final
        exponentiation (against the twin too where asked: once, the twin
        is slow) equal to the oracle's pairing products."""
        gt = PC.final_exp(f)
        return (exact(f, twin_f)
                and (not final_exp_twin or exact(gt, lambda: PR.final_exp(f)))
                and unpack_fq12(gt.cpu().numpy()) == [bn.pairing_batch(p) for p in pairs])

    def miller_final_exp():
        ps, qs = [g1s(b) for _ in range(2)], [g2s(b) for _ in range(2)]
        ps[0][0] = None  # lane 0: one pair at infinity
        P, Q = dev(pair_major(pack_g1, ps)), dev(pair_major(pack_g2, qs))
        f = PC.miller_product(P, Q)
        pairs = [[(ps[j][lane], qs[j][lane]) for j in range(2) if ps[j][lane] is not None]
                 for lane in range(b)]
        return check_gt(f, lambda: PR.miller_product(P, Q), pairs, final_exp_twin=True)

    q_fixed = g2s(2)
    lines, tails = LN.tables_from_numpy([LN.g2_line_table(q) for q in q_fixed], device)
    fixed = [g1s(b) for _ in range(2)]
    fixed[0][0] = None
    fixed_ps = tuple(dev(pack_g1(lane)) for lane in fixed)

    def fixed_pairs(lane):
        return [(fixed[j][lane], q_fixed[j]) for j in range(2) if fixed[j][lane] is not None]

    def miller_mixed_var():
        vp, vq = g1s(b), g2s(b)
        args = (dev(pack_g1(vp)), dev(pack_g2(vq)), fixed_ps, lines, tails)
        f = PC.miller_mixed(*args)
        return check_gt(f, lambda: PR.miller_mixed(*args),
                        [fixed_pairs(lane) + [(vp[lane], vq[lane])] for lane in range(b)])

    def miller_mixed_fixed_only():
        args = (None, None, fixed_ps, lines, tails)
        f = PC.miller_mixed(*args)
        return check_gt(f, lambda: PR.miller_mixed(*args), [fixed_pairs(lane) for lane in range(b)])

    stages = {}
    for name, fn in (("mont_mul", mont_mul), ("g2_on_curve", g2_on_curve), ("msm", msm),
                     ("miller_final_exp", miller_final_exp),
                     ("miller_mixed_var", miller_mixed_var),
                     ("miller_mixed_fixed_only", miller_mixed_fixed_only)):
        t0 = time.perf_counter()
        PC.reset_launch_counts()
        try:
            ok, error = bool(fn()), None
        except Exception as e:  # noqa: BLE001 — a stage's failure is its record
            ok, error = False, f"{type(e).__name__}: {e}"
        if on_card:
            _sync(device)
        launches = PC.launch_counts()
        unlaunched = [k for k in KERNEL_VALIDATION_COVERAGE[name] if on_card and not launches[k]]
        stages[name] = {"ok": ok and not unlaunched, "s": time.perf_counter() - t0,
                        "launches": {k: v for k, v in launches.items() if v}}
        if error or unlaunched:
            stages[name]["error"] = error or f"not launched: {unlaunched}"
    return stages


def bench_kernel_validation(run: Run) -> dict:
    """Every kernel entry point exact against its plain twin on a small
    batch (8 lanes on the card, 2 on the CPU, where the wrappers are the
    twins and only the oracle checks remain), and the coverage of
    KERNEL_ENTRY_POINTS."""
    from .ops.pairing_cuda import KERNEL_ENTRY_POINTS

    stages = _kernel_stages(run.device, 8 if run.device == "cuda" else 2)
    validated = set()
    for stage, kernels in KERNEL_VALIDATION_COVERAGE.items():
        if stages.get(stage, {}).get("ok"):
            validated.update(kernels)
    missing = [k for k in KERNEL_ENTRY_POINTS if k not in validated]
    stages["coverage"] = {"ok": not missing, **({"missing": missing} if missing else {})}
    ok = all(s["ok"] for s in stages.values())
    return run.line("kernel_validation", value=1 if ok else 0, unit="ok",
                    kernels="cuda" if run.device == "cuda" else "plain twins", stages=stages)


RUNNERS = {
    "groth16_batch": bench_groth16_batch,
    "plonk_batch": bench_plonk_batch,
    "msm": bench_msm,
    "mixed": bench_mixed,
    "groth16_single": bench_groth16_single,
    "plonk_single": bench_plonk_single,
    "scaling": bench_scaling,
    "kernel_validation": bench_kernel_validation,
}


def emit(line: dict) -> None:
    print(json.dumps(line), flush=True)


def _alarm(signum, frame):
    raise TimeoutError("per-config wall-clock budget exceeded")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny shapes, quick")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--configs", default="all", help="comma list of " + ",".join(ORDER))
    ap.add_argument("--msm-c", type=int, default=8, help="Pippenger window bits")
    ap.add_argument("--msm-log2n", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device (run with --device cpu for the plain twins)",
              file=sys.stderr)
        return 2
    wanted = ORDER if args.configs == "all" else args.configs.split(",")
    unknown = [c for c in wanted if c not in RUNNERS]
    if unknown:
        ap.error(f"unknown configs {unknown}")
    if "groth16_batch" in wanted:  # the headline first
        wanted = ["groth16_batch"] + [c for c in wanted if c != "groth16_batch"]
    run = Run(batch_size=args.batch or (32 if args.smoke else 1024),
              msm_window_bits=args.msm_c, device=args.device,
              iters=args.iters or (2 if args.smoke else 8),
              log2n=args.msm_log2n or (10 if args.smoke else 16),
              card=card_fields(args.device))

    t0 = time.perf_counter()
    build = {"build_s": 0.0}
    if args.device == "cuda":
        from .ops import _build

        kl = _build.load_kernels()
        build = {"build_s": time.perf_counter() - t0, "nvcc_s": kl.build_s}
    emit({**build, "platform": args.device, **run.card})

    signal.signal(signal.SIGALRM, _alarm)
    t_start, headline, failed = time.time(), None, False
    for name in wanted:
        metric = METRICS[name].format(log2n=run.log2n)
        remaining = GLOBAL_BUDGET_S - (time.time() - t_start)
        if remaining < 30:
            emit({"metric": metric, "error": f"skipped: global bench budget exhausted "
                  f"({GLOBAL_BUDGET_S}s)"})
            failed = True
            continue
        try:
            signal.alarm(int(min(BUDGETS[name], remaining)))
            line = RUNNERS[name](run)
            signal.alarm(0)
            if line.get("value") == 0 and line.get("unit") == "ok":
                failed = True  # a validation that did not pass
            emit(line)
            if name == "groth16_batch":
                headline = line
        except Exception as e:  # noqa: BLE001 — isolation is the point
            signal.alarm(0)
            failed = True
            emit({"metric": metric, "error": f"{type(e).__name__}: {e}",
                  "trace_tail": traceback.format_exc().strip().splitlines()[-3:]})
    if headline is not None and len(wanted) > 1:
        emit(headline)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (snark_bn254_verifier_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/, then

  1. checks each kernel of KERNEL_ENTRY_POINTS against its plain PyTorch
     twin on the card (exact equality: integer field arithmetic) and a few
     lanes against the oracle, at the main path's shapes (batch 1024, with
     edge lanes), then on inputs where about half the lanes take the
     infinity or skip branches (and K2 on 9 points, more than one Straus
     group), and times kernel and twin, each warm;
  2. drives the main path, ``Groth16BatchVerifier(vk, device="cuda")`` on a
     batch of 1024 proofs of the bench vector with bad lanes at fixed
     positions, checks the exact bool vector and that every kernel was
     launched, checks a small batch against the CPU run, and times warm
     batches.

It imports no JAX. It prints the card's name and power limit, one JSON
line with the kernels' results, and as its last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before that line; without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

BATCH = 1024  # proofs per batch, the batch the repo's bench verifies
ITERS = 3     # warm slice runs timed
SEED = 0
SOURCE = "snark_bn254_verifier_tpu_torch/csrc/kernels.cu"
PALLAS = "snark_bn254_verifier_tpu/ops/"
# kernel -> (TPU kernels it replaces, file:line); the first is "replaces"
REPLACES = {
    "mont_mul": [PALLAS + "field_pallas.py:37"],
    "msm_affine": [PALLAS + "pairing_pallas.py:206", PALLAS + "pairing_pallas.py:271"],
    "miller_mixed": [PALLAS + "pairing_pallas.py:99"],
    "final_exp": [PALLAS + "pairing_pallas.py:179", PALLAS + "pairing_pallas.py:191"],
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_kernel(fn, iters: int) -> float:
    """Mean ms of ``fn`` over ``iters`` launches, by CUDA events (warm)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_plain(fn):
    """(result, ms) of a plain twin on the card: one warm-up call (torch's
    lazy CUDA start-up), then one synchronised, timed call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def max_abs_err(a, b) -> int:
    return int((a.to(dtype=b.dtype) - b).abs().max().item()) if a.numel() else 0


class Ctx:
    """Shared inputs of the phases: seeded generators and oracle pools."""

    def __init__(self, batch: int, seed: int):
        import numpy as np
        import torch

        from snark_bn254_verifier_tpu.oracle import bn254 as bn

        self.batch = batch
        self.dev = torch.device("cuda")
        self.rng = np.random.default_rng(seed)
        prng = random.Random(seed)
        self.g1_pool = [bn.g1_mul(bn.G1_GEN, prng.randrange(1, bn.R)) for _ in range(8)]
        self.g2_pool = [bn.g2_mul(bn.G2_GEN, prng.randrange(1, bn.R)) for _ in range(4)]
        self.q_fixed = [bn.g2_mul(bn.G2_GEN, prng.randrange(1, bn.R)) for _ in range(2)]
        self.miller_out = None  # K3's output, K4's input

    def rand_limbs(self, modulus: int, shape):
        """Uniform values below the modulus's top limb: (16, *shape) int32."""
        import numpy as np

        top = modulus >> 240
        limbs = self.rng.integers(0, 1 << 16, size=(16,) + tuple(shape), dtype=np.int64)
        limbs[15] = self.rng.integers(0, top, size=tuple(shape))
        return limbs.astype(np.int32)

    def lanes(self, pool, k):
        return [pool[i] for i in self.rng.integers(0, len(pool), size=k)]


def phase_mont_mul(ctx):
    import torch

    from snark_bn254_verifier_tpu_torch.ops import field as F
    from snark_bn254_verifier_tpu_torch.ops import field_cuda as FC
    from snark_bn254_verifier_tpu_torch.ops.limbs import FQ, FR, limbs_batch_to_ints

    rows = {}
    # Fq at the G2 mask's stacked shape; Fr at one product per lane
    for spec, shape in ((FQ, (3, ctx.batch)), (FR, (ctx.batch,))):
        a = ctx.rand_limbs(spec.modulus, shape)
        b = ctx.rand_limbs(spec.modulus, shape)
        edges = [0, 1, spec.modulus - 1, spec.modulus - 2]
        for lane, v in enumerate(edges):
            a[(slice(None),) + (0,) * (len(shape) - 1) + (lane,)] = spec.pack([v], mont=False)[:, 0]
            b[(slice(None),) + (0,) * (len(shape) - 1) + (lane,)] = spec.pack([edges[-1 - lane]], mont=False)[:, 0]
        a, b = torch.as_tensor(a, device=ctx.dev), torch.as_tensor(b, device=ctx.dev)
        got = FC.mont_mul(spec, a, b)
        want, plain_ms = time_plain(lambda: F.mont_mul(spec, a, b))
        err = max_abs_err(got, want)
        require(err == 0, f"mont_mul[{spec.name}] differs from its plain twin")
        fa, fb, fo = (x.reshape(16, -1)[:, :8].cpu().numpy() for x in (a, b, got))
        for x, y, z in zip(limbs_batch_to_ints(fa), limbs_batch_to_ints(fb), limbs_batch_to_ints(fo)):
            require(z == x * y * spec.r_inv % spec.modulus, f"mont_mul[{spec.name}] != oracle")
        ms = time_kernel(lambda: FC.mont_mul(spec, a, b), 50)
        rows[spec.name] = (tuple(a.shape), err, ms, plain_ms)
        print(f"K1 mont_mul {spec.name} {tuple(a.shape)}: exact vs plain, oracle ok; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms (warm)")
    shape, _, ms, plain_ms = rows["fq"]  # kernel and twin at one field and shape
    return {"max_abs_err": max(r[1] for r in rows.values()), "ms": ms, "plain_ms": plain_ms,
            "shape": list(shape)}


def msm_inputs(ctx, n, p_inf=0.0, p_zero=0.0):
    """n G1 points per lane from the pool, each at infinity with
    probability ``p_inf``, and canonical Fr scalars, each zero with
    probability ``p_zero``: (pts[j][lane] or None, sc (n, 16, b))."""
    from snark_bn254_verifier_tpu.oracle import bn254 as bn

    b = ctx.batch
    pts = [ctx.lanes(ctx.g1_pool, b) for _ in range(n)]
    sc = ctx.rand_limbs(bn.R, (n, b)).transpose(1, 0, 2).copy()  # (n, 16, b)
    for j in range(n):
        for lane in range(b):
            if ctx.rng.random() < p_inf:
                pts[j][lane] = None
        sc[j][:, ctx.rng.random(b) < p_zero] = 0
    return pts, sc


def check_msm(ctx, label, pts, sc, lanes, twin=True):
    """K2 on (pts, sc): all lanes equal to the plain twin (if ``twin``),
    ``lanes`` equal to the oracle. Returns (inputs, max_abs_err, plain ms)."""
    import numpy as np
    import torch

    from snark_bn254_verifier_tpu.oracle import bn254 as bn
    from snark_bn254_verifier_tpu_torch.models.packing import pack_g1, unpack_fq
    from snark_bn254_verifier_tpu_torch.ops import curve as C
    from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC
    from snark_bn254_verifier_tpu_torch.ops.limbs import limbs_batch_to_ints

    n = len(pts)
    packed = [pack_g1(p) for p in pts]
    points = tuple(torch.as_tensor(np.stack([p[i] for p in packed]), device=ctx.dev)
                   for i in range(3))
    scal = torch.as_tensor(sc, device=ctx.dev)
    got = PC.msm_affine(points, scal)
    err, plain_ms = 0, None
    if twin:
        want, plain_ms = time_plain(lambda: C.msm_affine(points, scal))
        err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]),
                  int((got[2] != want[2]).sum().item()))
        require(err == 0, f"msm_affine ({label}) differs from its plain twin")
    xs = unpack_fq(got[0][:, lanes].cpu().numpy())
    ys = unpack_fq(got[1][:, lanes].cpu().numpy())
    infs = got[2][lanes].cpu().numpy()
    scal_ints = [limbs_batch_to_ints(sc[j][:, lanes]) for j in range(n)]
    for k, lane in enumerate(lanes):
        keep = [j for j in range(n) if pts[j][lane] is not None]
        want_pt = bn.g1_msm([pts[j][lane] for j in keep], [scal_ints[j][k] for j in keep])
        got_pt = None if infs[k] else (xs[k], ys[k])
        require(got_pt == want_pt, f"msm_affine ({label}) lane {lane} != oracle")
    print(f"K2 msm_affine {label} n={n} B={ctx.batch}: "
          + ("exact vs plain, " if twin else "")
          + f"oracle ok ({len(lanes)} lanes)")
    return (points, scal), err, plain_ms


def phase_msm_affine(ctx):
    from snark_bn254_verifier_tpu.oracle import bn254 as bn
    from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC
    from snark_bn254_verifier_tpu_torch.ops.limbs import FR

    # the main path's shape: 3 points; edge lanes: zero scalars, an
    # infinite point, scalar r-1, one point thrice (the adds double),
    # P + (-P), all points infinite
    pts, sc = msm_inputs(ctx, 3)
    sc[:, :, 0] = 0
    pts[1][1] = None
    sc[0, :, 2] = FR.pack([bn.R - 1], mont=False)[:, 0]
    pts[1][3] = pts[2][3] = pts[0][3]
    sc[1, :, 3] = sc[2, :, 3] = sc[0, :, 3]
    pts[1][4] = bn.g1_neg(pts[0][4])
    sc[1, :, 4] = sc[0, :, 4]
    pts[2][4] = None
    for j in range(3):
        pts[j][5] = None
    args, err, plain_ms = check_msm(ctx, "bench shape", pts, sc, list(range(8)))
    ms = time_kernel(lambda: PC.msm_affine(*args), 3)
    print(f"K2 msm_affine bench shape: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms (warm)")
    # lanes diverge: half the points at infinity, a quarter of the scalars zero
    pts, sc = msm_inputs(ctx, 3, p_inf=0.5, p_zero=0.25)
    _, e, _ = check_msm(ctx, "half the points infinite", pts, sc, list(range(8)))
    err = max(err, e)
    # more points than one Straus group: partial sums are combined
    pts, sc = msm_inputs(ctx, 9, p_inf=0.1)
    check_msm(ctx, "9 points", pts, sc, list(range(0, ctx.batch, ctx.batch // 16)), twin=False)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "shape": [3, 16, ctx.batch]}


def phase_miller_mixed(ctx):
    import numpy as np
    import torch

    from snark_bn254_verifier_tpu.oracle import bn254 as bn
    from snark_bn254_verifier_tpu_torch.models.packing import pack_g1, pack_g2, unpack_fq12
    from snark_bn254_verifier_tpu_torch.ops import lines as LN
    from snark_bn254_verifier_tpu_torch.ops import pairing as PR
    from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC

    b = ctx.batch
    lines, tails = LN.tables_from_numpy([LN.g2_line_table(q) for q in ctx.q_fixed], ctx.dev)

    def dev(tup):
        return tuple(torch.as_tensor(x, device=ctx.dev) for x in tup)

    def inputs(p_var, p_fixed):
        """Variable and fixed pairs per lane, each variable point at
        infinity with probability ``p_var``, each fixed one with
        ``p_fixed``, plus the edge lanes 0-3."""
        vp, vq = ctx.lanes(ctx.g1_pool, b), ctx.lanes(ctx.g2_pool, b)
        fl = [ctx.lanes(ctx.g1_pool, b) for _ in range(2)]
        for pts, p in ((vp, p_var), (vq, p_var), (fl[0], p_fixed), (fl[1], p_fixed)):
            for lane in np.flatnonzero(ctx.rng.random(b) < p):
                pts[lane] = None
        vp[0] = None       # variable P at infinity
        vq[1] = None       # variable Q at infinity
        fl[0][2] = None    # one fixed P at infinity
        fl[0][3] = fl[1][3] = None
        return vp, vq, fl

    realistic = inputs(0.0, 0.0)
    # lanes diverge: about half skip the variable pair (P or Q at
    # infinity), each fixed pair is skipped on half the lanes
    divergent = inputs(0.3, 0.5)
    var_skip = sum((p is None or q is None) for p, q in zip(*divergent[:2]))
    fixed_skip = sum(p is None for p in divergent[2][0])
    cases = [("has_var=True nf=2", realistic, True),
             (f"has_var=True nf=2, {var_skip}/{b} lanes skip the var pair, "
              f"{fixed_skip} the first fixed one", divergent, True),
             ("fixed-only nf=2, same lanes", divergent, False)]
    err, ms, plain_ms = 0, None, None
    for label, (vp, vq, fl), has_var in cases:
        fixed = tuple(dev(pack_g1(lane)) for lane in fl)
        args = (dev(pack_g1(vp)), dev(pack_g2(vq)), fixed) if has_var else (None, None, fixed)
        got = PC.miller_mixed(*args, lines, tails)
        timed = ms is None
        if timed:
            want, plain_ms = time_plain(lambda: PR.miller_mixed(*args, lines, tails))
        else:
            want = PR.miller_mixed(*args, lines, tails)
        e = max_abs_err(got, want)
        require(e == 0, f"miller_mixed ({label}) differs from its plain twin")
        f_host = unpack_fq12(got[:, :, :8].cpu().numpy())
        for lane in range(8):
            pairs = [(fl[j][lane], ctx.q_fixed[j]) for j in range(2) if fl[j][lane] is not None]
            if has_var and vp[lane] is not None and vq[lane] is not None:
                pairs.append((vp[lane], vq[lane]))
            require(bn.final_exponentiation(f_host[lane]) == bn.pairing_batch(pairs),
                    f"miller_mixed ({label}) lane {lane} != oracle after final exp")
        msg = f"K3 miller_mixed {label} B={b}: exact vs plain, oracle ok (8 lanes)"
        if timed:
            ms = time_kernel(lambda: PC.miller_mixed(*args, lines, tails), 3)
            msg += f"; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms (warm)"
            ctx.miller_out = got
        print(msg)
        err = max(err, e)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "shape": [16, 12, b]}


def phase_final_exp(ctx):
    import numpy as np
    import torch

    from snark_bn254_verifier_tpu.oracle import bn254 as bn
    from snark_bn254_verifier_tpu_torch.models.packing import pack_fq12, unpack_fq12
    from snark_bn254_verifier_tpu_torch.ops import pairing as PR
    from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC

    # Miller values; a bad lane may hold any Fq12, so half the lanes hold
    # arbitrary ones: zero (lane 0), one (lane 1), random limbs below p
    f = ctx.miller_out.clone()
    bad = ctx.rng.random(ctx.batch) < 0.5
    bad[:4] = [True, True, False, False]
    rand = torch.as_tensor(ctx.rand_limbs(bn.P, (12, ctx.batch)), device=ctx.dev)
    f[:, :, bad] = rand[:, :, bad]
    f[:, :, 0] = 0
    f[:, :, 1] = torch.as_tensor(pack_fq12([bn.FQ12_ONE]), device=ctx.dev)[:, :, 0]
    got = PC.final_exp(f)
    want, plain_ms = time_plain(lambda: PR.final_exp(f))
    err = max_abs_err(got, want)
    require(err == 0, "final_exp differs from its plain twin")
    lanes = [1, 2, 3] + (np.flatnonzero(bad[4:])[:2] + 4).tolist()
    host_in = unpack_fq12(f[:, :, lanes].cpu().numpy())
    host_out = unpack_fq12(got[:, :, lanes].cpu().numpy())
    for k, lane in enumerate(lanes):
        require(host_out[k] == bn.final_exponentiation(host_in[k]),
                f"final_exp lane {lane} != oracle")
    ms = time_kernel(lambda: PC.final_exp(f), 3)
    print(f"K4 final_exp B={ctx.batch}, {int(bad.sum())} lanes arbitrary: exact vs plain, "
          f"oracle ok ({len(lanes)} lanes); kernel {ms:.3f} ms, plain {plain_ms:.1f} ms (warm)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "shape": [16, 12, ctx.batch]}


# One on-card phase per entry of KERNEL_ENTRY_POINTS (checked by
# tests/test_torch_kernel_registry.py).
KERNEL_PHASES = {
    "mont_mul": phase_mont_mul,
    "msm_affine": phase_msm_affine,
    "miller_mixed": phase_miller_mixed,
    "final_exp": phase_final_exp,
}


def slice_inputs(batch: int):
    """The bench vector at ``batch`` proofs with bad lanes at fixed
    positions; all proofs keep one length, so the native parser runs."""
    from snark_bn254_verifier_tpu.fixtures.gen import gen_groth16_vector

    vec = gen_groth16_vector(0, num_inputs=2)
    other = gen_groth16_vector(1, num_inputs=2)
    proofs = [vec.proof] * batch
    inputs = [list(vec.public_inputs) for _ in range(batch)]
    expected = [True] * batch
    bad_a = bytearray(vec.proof)
    bad_a[5] ^= 0xFF                  # corrupt A.x
    off_b = bytearray(vec.proof)
    off_b[64 + 127] ^= 1              # B.y changed: B off the curve
    bad = {
        3: ("proof", bytes(bad_a)),
        5: ("proof", bytes(off_b)),
        7: ("inputs", [1, 2]),        # wrong input values
        11: ("inputs", [1]),          # wrong input count
        13: ("proof", other.proof),   # a proof of another statement
    }
    for lane, (kind, val) in bad.items():
        if lane >= batch:
            continue
        if kind == "proof":
            proofs[lane] = val
        else:
            inputs[lane] = val
        expected[lane] = False
    return vec, proofs, inputs, expected


def run_slice(batch: int, iters: int):
    import numpy as np

    from snark_bn254_verifier_tpu_torch import Groth16BatchVerifier
    from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC

    vec, proofs, inputs, expected = slice_inputs(batch)
    ver = Groth16BatchVerifier(vec.vk, device="cuda")
    ver.line_tables()  # once-per-VK host work, outside the counted run
    ver.alpha_beta()
    PC.reset_launch_counts()
    ok = ver.verify_batch(proofs, inputs)
    launches = PC.launch_counts()
    require(ok.tolist() == expected, f"slice bool vector wrong: False at "
            f"{np.flatnonzero(~ok).tolist()}, expected {[i for i, e in enumerate(expected) if not e]}")
    require(ver.last_stats.extra["parser"] == "native", "native parser did not run")
    for name in PC.KERNEL_ENTRY_POINTS:
        require(launches[name] > 0, f"kernel {name} was not launched by the main path")
    print(f"slice B={batch}: bool vector exact ({int(ok.sum())} True), launches {launches}")

    # the same small batch on the CPU (plain twins) gives the same answer
    small = 16
    cpu = Groth16BatchVerifier(vec.vk, device="cpu").verify_batch(proofs[:small], inputs[:small])
    require(cpu.tolist() == ok[:small].tolist(), "CUDA and CPU runs disagree on the first 16 lanes")
    print(f"slice: first {small} lanes equal to the CPU run")

    times, stages = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        ok = ver.verify_batch(proofs, inputs)
        times.append(time.perf_counter() - t0)
        stages.append(ver.last_stats.extra["stage_ms"])
        require(ok.tolist() == expected, "slice bool vector changed between runs")
    best = min(times)
    mean_stage = {k: sum(s[k] for s in stages) / len(stages) for k in stages[0]}
    print(f"slice warm: {iters} runs, batch s {[round(t, 4) for t in times]}, "
          f"{batch / best:.1f} proofs/s (best), {batch * iters / sum(times):.1f} proofs/s (mean)")
    print("slice stage ms (mean): " + json.dumps({k: round(v, 3) for k, v in mean_stage.items()}))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    from snark_bn254_verifier_tpu_torch.ops import _build
    from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC

    t0 = time.perf_counter()
    kl = _build.load_kernels()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {kl.build_s:.1f} s)")
    for line in kl.build_log.splitlines():
        if "Compiling entry" in line or "Used" in line:
            print("  " + line.strip())
    require(set(KERNEL_PHASES) == set(PC.KERNEL_ENTRY_POINTS), "a kernel has no phase")

    ctx = Ctx(BATCH, SEED)
    results = {name: KERNEL_PHASES[name](ctx) for name in PC.KERNEL_ENTRY_POINTS}
    launches = run_slice(BATCH, ITERS)

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name][0],
            "also_replaces": REPLACES[name][1:],
            "launches": launches[name],
            "max_abs_err": results[name]["max_abs_err"],
            "ms": results[name]["ms"],
            "plain_ms": results[name]["plain_ms"],
            "shape": results[name]["shape"],
        }
        for name in PC.KERNEL_ENTRY_POINTS
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

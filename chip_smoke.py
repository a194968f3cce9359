#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (snark_bn254_verifier_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/, then

  1. checks each kernel of KERNEL_ENTRY_POINTS against its plain PyTorch
     twin on the card (exact equality: integer field arithmetic) and a few
     lanes against the oracle, at the batched path's shapes (batch 1024,
     with edge lanes), then on inputs where about half the lanes take the
     infinity or skip branches (and K2 on 9 points, more than one Straus
     group), and times kernel and twin, each warm; then K2 (11 and 1
     points), K4 and K5 (3 and 2 pairs) at batch one, the single-proof
     path's shapes, exact against their twins and timed on those inputs;
  2. drives the batched path, ``Groth16BatchVerifier(vk, device="cuda")``
     on a batch of 1024 proofs of the bench vector with bad lanes at fixed
     positions, checks the exact bool vector and that its kernels (K1-K4)
     were launched, checks a small batch against the CPU run, and times
     warm batches;
  3. drives the single-proof path, ``Groth16Verifier.verify`` and
     ``PlonkVerifier.verify`` with ``device="cuda"``, on a good proof, a
     wrong input value, a wrong input count, a corrupted proof byte and,
     for PlonK, a doubled opening proof that fails in the pairing check;
     each result or exception must equal the oracle backend's, and its
     kernels (K2, K4, K5) must have been launched; then times warm calls
     and splits one call into its primitives.

Each path's launch counts are set to 0 just before it is driven and read
just after; together the paths must launch every kernel. It imports no
JAX. It prints the card's name and power limit, one JSON line with the
kernels' results, and as its last line ``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero before that line; without a CUDA
device it exits non-zero at once.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

BATCH = 1024  # proofs per batch, the batch the repo's bench verifies
ITERS = 3     # warm slice runs timed
SINGLE_ITERS = 10  # warm single-proof calls timed, per protocol
SEED = 0
SOURCE = "snark_bn254_verifier_tpu_torch/csrc/kernels.cu"
PALLAS = "snark_bn254_verifier_tpu/ops/"
# kernel -> (TPU kernels it replaces, file:line); the first is "replaces"
REPLACES = {
    "mont_mul": [PALLAS + "field_pallas.py:37"],
    "msm_affine": [PALLAS + "pairing_pallas.py:206", PALLAS + "pairing_pallas.py:271"],
    "miller_mixed": [PALLAS + "pairing_pallas.py:99"],
    "final_exp": [PALLAS + "pairing_pallas.py:179", PALLAS + "pairing_pallas.py:191"],
    "miller_product": [PALLAS + "pairing_pallas.py:84", PALLAS + "pairing_pallas.py:171"],
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


def time_plain(fn, warm_up=True):
    """(result, ms) of a plain twin on the card: one warm-up call (torch's
    lazy CUDA start-up; skipped where the twin already ran on the card at
    another batch), then one synchronised, timed call."""
    import torch

    if warm_up:
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


def msm_inputs(ctx, n, p_inf=0.0, p_zero=0.0, b=None):
    """n G1 points per lane over ``b`` lanes (default the batch) from the
    pool, each at infinity with probability ``p_inf``, and canonical Fr
    scalars, each zero with probability ``p_zero``: (pts[j][lane] or None,
    sc (n, 16, b))."""
    from snark_bn254_verifier_tpu.oracle import bn254 as bn

    b = ctx.batch if b is None else b
    pts = [ctx.lanes(ctx.g1_pool, b) for _ in range(n)]
    sc = ctx.rand_limbs(bn.R, (n, b)).transpose(1, 0, 2).copy()  # (n, 16, b)
    for j in range(n):
        for lane in range(b):
            if ctx.rng.random() < p_inf:
                pts[j][lane] = None
        sc[j][:, ctx.rng.random(b) < p_zero] = 0
    return pts, sc


def check_msm(ctx, label, pts, sc, lanes, twin=True, warm_up=True):
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
        want, plain_ms = time_plain(lambda: C.msm_affine(points, scal), warm_up)
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
    print(f"K2 msm_affine {label} n={n} B={sc.shape[-1]}: "
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
    out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "shape": [3, 16, ctx.batch]}
    # the single-proof path's shapes, batch one: PlonK's largest MSM (11
    # points, three groups) and a g1_mul (1 point); timed on the inputs
    # that were compared
    for n in (11, 1):
        pts, sc = msm_inputs(ctx, n, b=1)
        args, e, out[f"plain_ms_b1_n{n}"] = check_msm(ctx, "single path", pts, sc, [0],
                                                      warm_up=False)
        out["max_abs_err"] = max(out["max_abs_err"], e)
        out[f"ms_b1_n{n}"] = time_kernel(lambda: PC.msm_affine(*args), 3)
        print(f"K2 msm_affine B=1 n={n}: kernel {out[f'ms_b1_n{n}']:.3f} ms, "
              f"plain {out[f'plain_ms_b1_n{n}']:.1f} ms")
    return out


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
    out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "shape": [16, 12, ctx.batch]}
    # the single-proof path's shape, batch one: a Miller value of a lane
    # whose pairs are all finite (K3's lane 4)
    one = ctx.miller_out[:, :, 4:5].contiguous()
    got = PC.final_exp(one)
    want, out["plain_ms_b1"] = time_plain(lambda: PR.final_exp(one), warm_up=False)
    e = max_abs_err(got, want)
    require(e == 0, "final_exp (B=1) differs from its plain twin")
    require(unpack_fq12(got.cpu().numpy())[0]
            == bn.final_exponentiation(unpack_fq12(one.cpu().numpy())[0]),
            "final_exp (B=1) != oracle")
    out["max_abs_err"] = max(err, e)
    out["ms_b1"] = time_kernel(lambda: PC.final_exp(one), 3)
    print(f"K4 final_exp B=1: exact vs plain, oracle ok; kernel {out['ms_b1']:.3f} ms, "
          f"plain {out['plain_ms_b1']:.1f} ms")
    return out


def miller_product_inputs(ctx, n):
    """n (P, Q) pairs per lane from the pools. About half the lanes put
    one pair's P or Q at infinity; edge lanes: 0 every P infinite, 1 the
    first Q infinite, 2 the last P infinite (in the last group for n > 4),
    3 all finite, 4 the first pair infinite by its mask alone (its
    coordinates kept: the wrapper must zero them), 5 a pair and its
    negation on one Q (the product is one). Returns (ps, qs, masked):
    per-pair lane lists (None = infinity) and the mask-only lanes."""
    from snark_bn254_verifier_tpu.oracle import bn254 as bn

    b = ctx.batch
    ps = [ctx.lanes(ctx.g1_pool, b) for _ in range(n)]
    qs = [ctx.lanes(ctx.g2_pool, b) for _ in range(n)]
    for lane in range(6, b):
        if ctx.rng.random() < 0.5:
            j = int(ctx.rng.integers(0, n))
            (ps if ctx.rng.random() < 0.5 else qs)[j][lane] = None
    for j in range(n):
        ps[j][0] = None
    qs[0][1] = None
    ps[n - 1][2] = None
    if n >= 2:
        ps[1][5], qs[1][5] = bn.g1_neg(ps[0][5]), qs[0][5]
    return ps, qs, {(0, 4)}


def pack_pair_lanes(ctx, ps, qs, masked):
    """Per-pair lane lists -> pair-major tensors on the card: P (x, y
    (n,16,B), inf (n,B)), Q (x, y (n,16,2,B), inf (n,B))."""
    import torch

    from snark_bn254_verifier_tpu_torch.models.packing import pack_g1, pack_g2, pair_major

    p, q = pair_major(pack_g1, ps), pair_major(pack_g2, qs)
    for j, lane in masked:
        p[2][j, lane] = True
    return (tuple(torch.as_tensor(a, device=ctx.dev) for a in p),
            tuple(torch.as_tensor(a, device=ctx.dev) for a in q))


def phase_miller_product(ctx):
    from snark_bn254_verifier_tpu.oracle import bn254 as bn
    from snark_bn254_verifier_tpu_torch.models.packing import unpack_fq12
    from snark_bn254_verifier_tpu_torch.ops import pairing as PR
    from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC

    b = ctx.batch
    out = {"max_abs_err": 0, "shape": [3, 16, b]}
    # n = 3: Groth16's generic product; 2: PlonK's KZG check; 5: two groups
    for n in (3, 2, 5):
        ps, qs, masked = miller_product_inputs(ctx, n)
        P, Q = pack_pair_lanes(ctx, ps, qs, masked)
        skipping = int((P[2] | Q[2]).any(0).sum().item())
        got = PC.miller_product(P, Q)
        if n == 3:
            want, out["plain_ms"] = time_plain(lambda: PR.miller_product(P, Q))
        else:
            want = PR.miller_product(P, Q)
        err = max_abs_err(got, want)
        require(err == 0, f"miller_product (n={n}) differs from its plain twin")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        lanes = list(range(8))
        gt = unpack_fq12(PC.final_exp(got[:, :, lanes]).cpu().numpy())
        for k, lane in enumerate(lanes):
            pairs = [(ps[j][lane], qs[j][lane]) for j in range(n)
                     if ps[j][lane] is not None and qs[j][lane] is not None
                     and (j, lane) not in masked]
            require(gt[k] == bn.pairing_batch(pairs),
                    f"miller_product (n={n}) lane {lane} != oracle after final exp")
        msg = (f"K5 miller_product n={n} B={b}, {skipping} lanes with an infinite pair: "
               f"exact vs plain, oracle ok ({len(lanes)} lanes)")
        if n == 3:
            out["ms"] = time_kernel(lambda: PC.miller_product(P, Q), 3)
            msg += f"; kernel {out['ms']:.3f} ms, plain {out['plain_ms']:.1f} ms (warm)"
        print(msg)
        if n in (3, 2):
            # the single-proof path's shape, batch one: lane 3, whose pairs
            # are all finite; timed on the inputs that were compared
            one = (tuple(t[..., 3:4].contiguous() for t in P),
                   tuple(t[..., 3:4].contiguous() for t in Q))
            got1 = PC.miller_product(*one)
            want1, out[f"plain_ms_b1_n{n}"] = time_plain(lambda: PR.miller_product(*one),
                                                         warm_up=False)
            err = max(max_abs_err(got1, want1), max_abs_err(got1, got[:, :, 3:4]))
            require(err == 0, f"miller_product (n={n}, B=1) differs from its plain twin")
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out[f"ms_b1_n{n}"] = time_kernel(lambda: PC.miller_product(*one), 3)
            print(f"K5 miller_product n={n} B=1 (lane 3): exact vs plain and vs the batch; "
                  f"kernel {out[f'ms_b1_n{n}']:.3f} ms, plain {out[f'plain_ms_b1_n{n}']:.1f} ms")
    return out


# One on-card phase per entry of KERNEL_ENTRY_POINTS (checked by
# tests/test_torch_kernel_registry.py).
KERNEL_PHASES = {
    "mont_mul": phase_mont_mul,
    "msm_affine": phase_msm_affine,
    "miller_mixed": phase_miller_mixed,
    "final_exp": phase_final_exp,
    "miller_product": phase_miller_product,
}
# The kernels each path launches; together they cover KERNEL_ENTRY_POINTS.
SLICE_KERNELS = ("mont_mul", "msm_affine", "miller_mixed", "final_exp")
SINGLE_KERNELS = ("msm_affine", "final_exp", "miller_product")


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
    for name in SLICE_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched by the batched path")
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


def outcome(fn):
    """("ok", result) or ("raises", error class, message) of fn(), for the
    reference's error taxonomy; any other exception fails the run."""
    from snark_bn254_verifier_tpu.utils.errors import VerifierError

    try:
        return ("ok", fn())
    except VerifierError as e:
        return ("raises", type(e).__name__, str(e))


def single_cases():
    """(protocol, label, proof, vk, inputs) of the single-proof path: the
    SP1-shaped Groth16 vector and the synthetic PlonK one, each good, with
    a wrong input value, a wrong input count and a corrupted proof byte;
    and a PlonK proof whose opening proof is doubled, which fails in the
    pairing check on the card."""
    from snark_bn254_verifier_tpu.fixtures.gen import (
        gen_groth16_vector_sp1_shaped,
        gen_plonk_vector,
    )
    from snark_bn254_verifier_tpu.oracle import bn254 as bn
    from snark_bn254_verifier_tpu.utils import serialization as ser

    cases = []
    for proto, vec in (("groth16", gen_groth16_vector_sp1_shaped(0)),
                       ("plonk", gen_plonk_vector(0))):
        ins = list(vec.public_inputs)
        bad = bytearray(vec.proof)
        bad[40] ^= 0x01  # inside the first G1 point
        cases += [
            (proto, "good", vec.proof, vec.vk, ins),
            (proto, "wrong input value", vec.proof, vec.vk, [ins[0] + 1] + ins[1:]),
            (proto, "wrong input count", vec.proof, vec.vk, ins[:-1]),
            (proto, "corrupted proof byte", bytes(bad), vec.vk, ins),
        ]
    h = ser.load_plonk_proof_from_bytes(vec.proof).batched_proof.h
    doubled = vec.proof.replace(ser.g1_to_bytes(h), ser.g1_to_bytes(bn.g1_mul(h, 2)))
    require(doubled != vec.proof, "the opening proof was not found in the proof bytes")
    cases.append(("plonk", "opening proof doubled", doubled, vec.vk, ins))
    return cases


def split_call(proto, proof, vk, inputs):
    """Host ms of one warm call of the shared protocol code, and of each
    primitive it made (msm: K2, pairing: K5 + K4, each with its packing
    and its copy back)."""
    import torch

    from snark_bn254_verifier_tpu.models.groth16 import PreparedVerifyingKey, verify_groth16
    from snark_bn254_verifier_tpu.models.plonk import verify_plonk
    from snark_bn254_verifier_tpu.utils import serialization as ser
    from snark_bn254_verifier_tpu_torch import TorchBackend

    class TimedBackend(TorchBackend):
        """Records each primitive's synchronised host ms (g1_mul and
        pairing go through msm and pairing_batch)."""

        log = []

        def _timed(self, kind, size, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            self.log.append((kind, size, (time.perf_counter() - t0) * 1e3))
            return out

        def msm(self, points, scalars):
            return self._timed("msm", len(points), super().msm, points, scalars)

        def pairing_batch(self, pairs):
            return self._timed("pairing", len(pairs), super().pairing_batch, pairs)

        def pairing_batch_is_one(self, pairs):
            return self._timed("pairing", len(pairs), super().pairing_batch_is_one, pairs)

    tb = TimedBackend("cuda")
    if proto == "groth16":
        vk_obj = ser.load_groth16_verifying_key_from_bytes(vk)
        prepared = PreparedVerifyingKey.from_vk(vk_obj, tb)
        tb.log.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = verify_groth16(vk_obj, ser.load_groth16_proof_from_bytes(proof), inputs,
                            backend=tb, prepared=prepared)
    else:
        vk_obj = ser.load_plonk_verifying_key_from_bytes(vk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = verify_plonk(vk_obj, ser.load_plonk_proof_from_bytes(proof), inputs, backend=tb)
    total = (time.perf_counter() - t0) * 1e3
    require(ok is True, f"{proto}: the split call did not verify")
    return total, tb.log


def run_single(iters: int):
    """The single-proof path on the card: every case's outcome equal to the
    oracle backend's, K2/K4/K5 launched, then warm latency."""
    import statistics

    from snark_bn254_verifier_tpu.models.groth16 import Groth16Verifier as OracleGroth16
    from snark_bn254_verifier_tpu.models.plonk import PlonkVerifier as OraclePlonk
    from snark_bn254_verifier_tpu_torch import Groth16Verifier, PlonkVerifier
    from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC

    port = {"groth16": Groth16Verifier, "plonk": PlonkVerifier}
    oracle = {"groth16": OracleGroth16, "plonk": OraclePlonk}
    cases = single_cases()
    PC.reset_launch_counts()
    got = [outcome(lambda c=c: port[c[0]].verify(*c[2:], device="cuda")) for c in cases]
    launches = PC.launch_counts()
    for (proto, label, proof, vk, ins), g in zip(cases, got):
        want = outcome(lambda: oracle[proto].verify(proof, vk, ins, backend="oracle"))
        require(g == want, f"single {proto} ({label}): cuda {g} != oracle {want}")
        print(f"single {proto} ({label}): {g[0]} {g[1]}, equal to the oracle backend")
    for name in SINGLE_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched by the single-proof path")
    print(f"single: launches {launches}")

    for proto in ("groth16", "plonk"):
        _, _, proof, vk, ins = next(c for c in cases if c[0] == proto)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            ok = port[proto].verify(proof, vk, ins, device="cuda")
            times.append((time.perf_counter() - t0) * 1e3)
            require(ok is True, f"single {proto}: a warm call did not verify")
        total, log = split_call(proto, proof, vk, ins)
        prims = ", ".join(f"{k}[{n}] {ms:.3f}" for k, n, ms in log)
        rest = total - sum(ms for _, _, ms in log)
        print(f"single {proto} warm latency over {iters} calls: median "
              f"{statistics.median(times):.3f} ms, best {min(times):.3f} ms; "
              f"one call split: {total:.3f} ms = {prims}, host protocol code {rest:.3f} ms")
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
    slice_launches = run_slice(BATCH, ITERS)
    single_launches = run_single(SINGLE_ITERS)
    launches = {name: slice_launches[name] + single_launches[name]
                for name in PC.KERNEL_ENTRY_POINTS}
    require(set(SLICE_KERNELS) | set(SINGLE_KERNELS) == set(PC.KERNEL_ENTRY_POINTS),
            "a kernel is launched by no path")

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
            **{k: v for k, v in results[name].items() if "_b1" in k},
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

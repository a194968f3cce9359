#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (snark_bn254_verifier_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/, then

  1. checks each kernel of KERNEL_ENTRY_POINTS against its plain PyTorch
     twin on the card (exact equality: integer field arithmetic) and a few
     lanes against the oracle, at the batched path's shapes (batch 1024,
     with edge lanes), then on inputs where about half the lanes take the
     infinity or skip branches (and K2 on 9 points), and times kernel and
     twin, each warm (K1, elementwise and fused, alone in a CUDA graph
     too); then K2 (11, 11 and 2 points) and K3 (fixed-only, two pairs) on
     the inputs of one PlonK batch of 1024, recorded as it ran; then K2
     (11, 7, 2 and 1 points, every MSM of a PlonK single), K4 and K5 (3
     and 2 pairs) at batch one, the single-proof path's shapes, exact
     against their twins and timed on those inputs; K6 (the bucket MSM)
     exact against its twin, K2 and the oracle at 256 points, against the
     closed form at 2^16 points, timed there whole and stage by stage
     (CUDA events) and at each chunk length of PIP_CHUNKS, its halves (the
     window sums, then the combine) exact, and K2 against K6 on both
     sides of msm_best's switch; and computes each kernel's bound from the
     work its twin counts;
  2. drives the batched Groth16 path, ``Groth16BatchVerifier(vk,
     device="cuda")`` on a batch of 1024 proofs of the bench vector with
     bad lanes at fixed positions, checks the exact bool vector and that
     its kernels (K1 in its fused form g2_on_curve, exactly once, and
     K2-K4) were launched, checks a small batch against the CPU run, and
     times warm batches;
  3. drives the PlonK batch, ``PlonkBatchVerifier(vk, device="cuda")`` on
     1024 lanes of the synthetic BSB22 vector with bad lanes of every kind
     spread over the batch (fixtures/plonk_lanes.py), checks the exact
     bool vector, that each batch launches K2 three times, K3 once with no
     variable pair, K4 once and nothing else, and the first 8 lanes
     against the CPU run, and times warm batches with their stages;
     each batch path then runs PIPELINED batches through
     ``verify_batch_async``, at most two in flight, with the exact bools
     and the same launches on every batch, and prints the rate beside the
     synchronous one;
  4. drives the single-proof path, ``Groth16Verifier.verify`` and
     ``PlonkVerifier.verify`` with ``device="cuda"``, on a good proof, a
     wrong input value, a wrong input count, a corrupted proof byte and,
     for PlonK, a doubled opening proof that fails in the pairing check;
     each result or exception must equal the oracle backend's, and its
     kernels (K2, K4, K5) must have been launched; then times warm calls
     and splits one call into its primitives;
  5. drives the large MSM: ``TorchBackend.msm`` at 80 points (K6) and
     ``sharded_msm`` on 2^16 points over a world-size-1 NCCL group (K6's
     window sums, then its combine; no K2), both exact against the closed
     form, and times the latter;
  6. runs the port's bench (snark_bn254_verifier_tpu_torch/bench.py) in
     process at its smoke sizes (batch 32, 2 iterations, 2^10 MSM points,
     4 single calls), every config but ``scaling`` (a process a card,
     which the bench's own run measures; its launches are not this
     process's): every
     line without error, on cuda, under the JAX bench's metric name;
     kernel_validation covering every KERNEL_ENTRY_POINTS entry; the
     Groth16 batch launching its four kernels and the MSM K6.

Each path's launch counts (each bench config's too, but
kernel_validation's, which are comparison launches) are set to 0 just
before it is driven and read just after; together the paths must launch
every kernel but K1's
elementwise form, mont_mul, which no path launches (it is still checked
and timed); the large MSM must launch K6. It imports
neither JAX nor the JAX package. It prints the card's name and power
limit, one JSON line with the kernels' results (time, bound, share of the
bound, launches per path, registers, stack, shared bytes, team shape),
and as its last line ``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero before that line; without a CUDA
device it exits non-zero at once.
"""

from __future__ import annotations

import functools
import json
import random
import subprocess
import sys
import time

# The card's model (peaks, products a Montgomery multiply, bounds) is the
# port's utils/roofline.py, which the bench's roofline fields use too.
from snark_bn254_verifier_tpu_torch.utils.roofline import bound, count_fp_muls, pippenger_work

BATCH = 1024  # proofs per batch, the batch the repo's bench verifies
ITERS = 3     # warm slice runs timed
SINGLE_ITERS = 10  # warm single-proof calls timed, per protocol
SEED = 0
CSRC = "snark_bn254_verifier_tpu_torch/csrc/"
SOURCE = {"mont_mul": CSRC + "fp.cuh", "g2_on_curve": CSRC + "curve.cuh",
          "msm_affine": CSRC + "msm.cuh",
          "miller_mixed": CSRC + "team.cuh", "final_exp": CSRC + "team.cuh",
          "miller_product": CSRC + "team.cuh", "msm_pippenger": CSRC + "pippenger.cuh"}
# run on a team of threads per lane
TEAM_KERNELS = ("msm_affine", "miller_mixed", "final_exp", "miller_product")
PALLAS = "snark_bn254_verifier_tpu/ops/"
# kernel -> (TPU kernels it replaces, file:line); the first is "replaces"
REPLACES = {
    "mont_mul": [PALLAS + "field_pallas.py:37"],
    "g2_on_curve": [PALLAS + "field_pallas.py:37"],
    "msm_affine": [PALLAS + "pairing_pallas.py:206", PALLAS + "pairing_pallas.py:271"],
    "miller_mixed": [PALLAS + "pairing_pallas.py:99"],
    "final_exp": [PALLAS + "pairing_pallas.py:179", PALLAS + "pairing_pallas.py:191"],
    "miller_product": [PALLAS + "pairing_pallas.py:84", PALLAS + "pairing_pallas.py:171"],
    # no Pallas original: the JAX package's bucket MSM is XLA
    "msm_pippenger": ["snark_bn254_verifier_tpu/ops/msm.py:59"],
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


def time_graph(fn, iters: int) -> float:
    """Mean ms of the kernel that ``fn`` launches, on the card alone:
    ``iters`` launches captured in one CUDA graph, its replay timed by CUDA
    events, so no host launch time sits between the kernels. ``fn`` must
    launch on the current stream."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
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


def lane_cpu(args, lane):
    """One lane of a kernel's (nested tuple) arguments, on the CPU."""
    if isinstance(args, (tuple, list)):
        return type(args)(lane_cpu(a, lane) for a in args)
    return args[..., lane:lane + 1].contiguous().cpu()


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def run_recorded(fn):
    """(fn(), [(kernel, args), ...]): fn run with the arguments of every
    kernel wrapper that parallel/batch.py calls, itself or through
    ops/msm.py::msm_best, recorded. Both modules are handed recording
    stand-ins for their ``PC`` (ops/pairing_cuda.py), restored after; the
    wrappers and their launch counts stay the real ones."""
    import types

    from snark_bn254_verifier_tpu_torch.ops import msm
    from snark_bn254_verifier_tpu_torch.parallel import batch

    real = batch.PC
    calls = []

    def recorder(name):
        def rec(*args):
            calls.append((name, args))
            return getattr(real, name)(*args)
        return rec

    stand_in = types.SimpleNamespace(
        **{name: recorder(name) for name in real.KERNEL_ENTRY_POINTS})
    batch.PC = msm.PC = stand_in
    try:
        out = fn()
    finally:
        batch.PC = msm.PC = real
    return out, calls


@functools.lru_cache(maxsize=None)
def plonk_inputs(batch: int):
    """The PlonK batch: gen_plonk_vector(0) at ``batch`` lanes with bad
    lanes at fixed positions, four in the first eight (the lanes checked
    against the CPU run), then one every 37 lanes through every kind
    (fixtures/plonk_lanes.py). Returns (vector, proofs, inputs, expected)."""
    from snark_bn254_verifier_tpu_torch.fixtures.plonk_lanes import KINDS, plonk_batch_lanes

    bad = {1: "truncated", 3: "opening_doubled", 5: "claimed0", 6: "shifted_doubled"}
    bad.update({lane: KINDS[k % len(KINDS)] for k, lane in enumerate(range(40, batch, 37))})
    return plonk_batch_lanes(batch, bad)


def plonk_rng():
    """The KZG randomisers of the PlonK batch, seeded."""
    from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn

    rng = random.Random(SEED)
    return lambda: rng.randrange(1, bn.R)


def plonk_kernel_args(ctx):
    """The kernels' arguments of one PlonK batch on the card, at the main
    path's shapes and on its data; recorded once, for the K2 and K3
    phases."""
    from snark_bn254_verifier_tpu_torch import PlonkBatchVerifier

    if ctx.plonk_calls is None:
        vec, proofs, inputs, expected = plonk_inputs(ctx.batch)
        ver = PlonkBatchVerifier(vec.vk, device="cuda")
        ok, ctx.plonk_calls = run_recorded(
            lambda: ver.verify_batch(proofs, inputs, rng=plonk_rng()))
        require(ok.tolist() == expected, "PlonK batch bool vector wrong (kernel inputs)")
    return ctx.plonk_calls


class Ctx:
    """Shared inputs of the phases: seeded generators and oracle pools."""

    def __init__(self, batch: int, seed: int):
        import numpy as np
        import torch

        from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn

        self.batch = batch
        self.dev = torch.device("cuda")
        self.rng = np.random.default_rng(seed)
        prng = random.Random(seed)
        self.g1_pool = [bn.g1_mul(bn.G1_GEN, prng.randrange(1, bn.R)) for _ in range(8)]
        self.g2_pool = [bn.g2_mul(bn.G2_GEN, prng.randrange(1, bn.R)) for _ in range(4)]
        self.q_fixed = [bn.g2_mul(bn.G2_GEN, prng.randrange(1, bn.R)) for _ in range(2)]
        self.miller_out = None  # K3's output, K4's input
        self.plonk_calls = None  # the kernels' arguments of one PlonK batch

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

    from snark_bn254_verifier_tpu_torch.ops import _build
    from snark_bn254_verifier_tpu_torch.ops import field as F
    from snark_bn254_verifier_tpu_torch.ops import field_cuda as FC
    from snark_bn254_verifier_tpu_torch.ops.limbs import FQ, FR, limbs_batch_to_ints

    lib = _build.load_kernels().lib
    rows = {}
    # Fq at the shape the G2 mask gave K1 before its fused form (three
    # products a lane); Fr at one product per lane
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
        # the kernel alone (a graph of C-entry launches rewriting ``got``)
        # and the wrapper's back-to-back call rate
        ptrs = (a.data_ptr(), b.data_ptr(), got.data_ptr(), got[0].numel(),
                0 if spec is FQ else 1)
        ms = time_graph(
            lambda: lib.bn_mont_mul(*ptrs, torch.cuda.current_stream().cuda_stream), 1000)
        wrapper_ms = time_kernel(lambda: FC.mont_mul(spec, a, b), 50)
        require(torch.equal(got, want), f"mont_mul[{spec.name}] changed under the timed launches")
        rows[spec.name] = (tuple(a.shape), err, ms, wrapper_ms, plain_ms,
                           bound(a[0].numel(), nbytes(a, b, got)))
        print(f"K1 mont_mul {spec.name} {tuple(a.shape)}: exact vs plain, oracle ok; "
              f"kernel {ms:.5f} ms (graph), wrapper {wrapper_ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms (warm)")
    shape, _, ms, wrapper_ms, plain_ms, bnd = rows["fq"]  # kernel and twin at one field and shape
    return {"max_abs_err": max(r[1] for r in rows.values()), "ms": ms, "plain_ms": plain_ms,
            "wrapper_ms": wrapper_ms, "shape": list(shape), **bnd}


def phase_g2_on_curve(ctx):
    import torch

    from snark_bn254_verifier_tpu_torch.fixtures.g2_lanes import g2_mask_lanes
    from snark_bn254_verifier_tpu_torch.ops import _build
    from snark_bn254_verifier_tpu_torch.ops import curve as C
    from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC

    b = ctx.batch
    # half the lanes divergent; lanes 0-6: on, off, infinity by its flag
    # alone, infinity, invalid, off, off and invalid
    x, y, inf, valid, want = g2_mask_lanes(
        SEED, b, head=("on", "off", "inf_flag", "inf", "invalid", "off", "off_invalid"))
    bs = tuple(torch.as_tensor(a, device=ctx.dev) for a in (x, y, inf))
    tvalid = torch.as_tensor(valid, device=ctx.dev)
    got = PC.g2_on_curve(bs, tvalid)
    plain, plain_ms = time_plain(lambda: C.g2_on_curve(bs, tvalid))
    err = int((got != plain).sum().item())
    require(err == 0, "g2_on_curve differs from its plain twin")
    require(got.cpu().tolist() == want, "g2_on_curve differs from the oracle")
    require(want[:7] == [True, False, True, True, False, False, False],
            "g2_on_curve edge lanes 0-6 wrong")
    # the kernel alone (a graph of C-entry launches), the C entry's and the
    # wrapper's back-to-back call rates; each rewrites the same output
    lib = _build.load_kernels().lib
    ptrs = [t.data_ptr() for t in (*bs, tvalid, got)]

    def c_entry():
        lib.bn_g2_on_curve(*ptrs, b, torch.cuda.current_stream().cuda_stream)

    ms = time_graph(c_entry, 1000)
    c_entry_ms = time_kernel(c_entry, 200)
    wrapper_ms = time_kernel(lambda: PC.g2_on_curve(bs, tvalid), 50)
    require(torch.equal(got, plain), "g2_on_curve changed under the timed launches")
    print(f"K1 g2_on_curve B={b}, {b - sum(want)} lanes False, {int(inf.sum())} at infinity: "
          f"exact vs plain and oracle; kernel {ms:.5f} ms (graph), C entry {c_entry_ms:.4f} ms, "
          f"wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.3f} ms (warm)")
    # the work is data-independent: lane 0, on the curve
    per_lane = count_fp_muls(lambda: PC.g2_on_curve(*lane_cpu((bs, tvalid), 0)))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "c_entry_ms": c_entry_ms,
            "wrapper_ms": wrapper_ms, "shape": [16, 2, b],
            **bound(per_lane * b, nbytes(*bs, tvalid, got))}


def msm_inputs(ctx, n, p_inf=0.0, p_zero=0.0, b=None):
    """n G1 points per lane over ``b`` lanes (default the batch) from the
    pool, each at infinity with probability ``p_inf``, and canonical Fr
    scalars, each zero with probability ``p_zero``: (pts[j][lane] or None,
    sc (n, 16, b))."""
    from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn

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

    from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn
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
    from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn
    from snark_bn254_verifier_tpu_torch.ops import curve as C
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
    # lane 8: every point finite, a random scalar each (lanes 0-5 are edges)
    per_lane = count_fp_muls(lambda: C.msm_affine(*lane_cpu(args, 8)))
    out_t = PC.msm_affine(*args)
    bnd = bound(per_lane * ctx.batch, nbytes(*args[0], args[1], *out_t))
    print(f"K2 msm_affine bench shape: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms (warm)")
    # lanes diverge: half the points at infinity, a quarter of the scalars zero
    pts, sc = msm_inputs(ctx, 3, p_inf=0.5, p_zero=0.25)
    _, e, _ = check_msm(ctx, "half the points infinite", pts, sc, list(range(8)))
    err = max(err, e)
    # more points: nine threads' partial sums are combined
    pts, sc = msm_inputs(ctx, 9, p_inf=0.1)
    check_msm(ctx, "9 points", pts, sc, list(range(0, ctx.batch, ctx.batch // 16)), twin=False)
    out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "shape": [3, 16, ctx.batch],
           **bnd}
    # the PlonK batch's three MSMs at batch 1024, on its own inputs (dead
    # lanes hold G1_GEN and zero scalars; the combo's digest is at
    # infinity there): the linearisation (n = 11), the combo (n = 11) and
    # the quotient (n = 2); work counted on lane 0, a good proof
    msm_calls = [args for name, args in plonk_kernel_args(ctx) if name == "msm_affine"]
    require(len(msm_calls) == 3, "the PlonK batch made other than three K2 calls")
    for label, args in zip(("plonk_lin", "plonk_combo", "plonk_quot"), msm_calls):
        got = PC.msm_affine(*args)
        want, plain = time_plain(lambda: C.msm_affine(*args), warm_up=False)
        e = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]),
                int((got[2] != want[2]).sum().item()))
        require(e == 0, f"msm_affine ({label}) differs from its plain twin")
        out["max_abs_err"] = max(out["max_abs_err"], e)
        k_ms = time_kernel(lambda: PC.msm_affine(*args), 3)
        bnd_p = bound(count_fp_muls(lambda: C.msm_affine(*lane_cpu(args, 0))) * ctx.batch,
                      nbytes(*args[0], args[1], *got))
        out.update({f"ms_{label}": k_ms, f"plain_ms_{label}": plain,
                    f"bound_ms_{label}": bnd_p["bound_ms"], f"fp_muls_{label}": bnd_p["fp_muls"],
                    f"share_of_bound_{label}": bnd_p["bound_ms"] / k_ms,
                    f"shape_{label}": list(args[1].shape)})
        print(f"K2 msm_affine {label} n={args[1].shape[0]} B={ctx.batch}: exact vs plain; "
              f"kernel {k_ms:.3f} ms, plain {plain:.1f} ms, bound {bnd_p['bound_ms']:.4f} ms")
    # the single-proof path's shapes, batch one: every MSM of a PlonK
    # single (11, 7, 2 and 1 points; a g1_mul is one point); timed on the
    # inputs that were compared
    for n in (11, 7, 2, 1):
        pts, sc = msm_inputs(ctx, n, b=1)
        args, e, out[f"plain_ms_b1_n{n}"] = check_msm(ctx, "single path", pts, sc, [0],
                                                      warm_up=False)
        out["max_abs_err"] = max(out["max_abs_err"], e)
        out[f"ms_b1_n{n}"] = time_kernel(lambda: PC.msm_affine(*args), 3)
        out[f"bound_ms_b1_n{n}"] = bound(
            count_fp_muls(lambda: C.msm_affine(*lane_cpu(args, 0))),
            nbytes(*args[0], args[1]))["bound_ms"]
        print(f"K2 msm_affine B=1 n={n}: kernel {out[f'ms_b1_n{n}']:.3f} ms, "
              f"plain {out[f'plain_ms_b1_n{n}']:.1f} ms")
    return out


def phase_miller_mixed(ctx):
    import numpy as np
    import torch

    from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn
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
            # lane 4: every pair finite (lanes 0-3 are edges)
            per_lane = count_fp_muls(
                lambda: PR.miller_mixed(*lane_cpu(args, 4), lines.cpu(), tails.cpu()))
            flat = [t for pt in args[:2] for t in pt] + [t for pt in args[2] for t in pt]
            bnd = bound(per_lane * b, nbytes(*flat, lines, tails, got))
        print(msg)
        err = max(err, e)
    out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "shape": [16, 12, b], **bnd}
    # fixed-only (nf = 2) on the PlonK batch's own inputs: (combo, -quot)
    # over the KZG [1]_2 and [x]_2 tables; work counted on lane 0
    (args,) = [a for name, a in plonk_kernel_args(ctx) if name == "miller_mixed"]
    require(args[0] is None and args[1] is None and len(args[2]) == 2,
            "the PlonK batch's K3 call is not fixed-only with two pairs")
    got = PC.miller_mixed(*args)
    want, plain = time_plain(lambda: PR.miller_mixed(*args), warm_up=False)
    e = max_abs_err(got, want)
    require(e == 0, "miller_mixed (PlonK batch, fixed-only) differs from its plain twin")
    k_ms = time_kernel(lambda: PC.miller_mixed(*args), 3)
    fixed, p_lines, p_tails = args[2], args[3], args[4]
    bnd_p = bound(count_fp_muls(lambda: PR.miller_mixed(None, None, lane_cpu(fixed, 0),
                                                        p_lines.cpu(), p_tails.cpu())) * b,
                  nbytes(*[t for pt in fixed for t in pt], p_lines, p_tails, got))
    out.update({"max_abs_err": max(err, e), "ms_plonk_fixed_only": k_ms,
                "plain_ms_plonk_fixed_only": plain,
                "bound_ms_plonk_fixed_only": bnd_p["bound_ms"],
                "fp_muls_plonk_fixed_only": bnd_p["fp_muls"],
                "share_of_bound_plonk_fixed_only": bnd_p["bound_ms"] / k_ms})
    print(f"K3 miller_mixed PlonK batch fixed-only nf=2 B={b}: exact vs plain; kernel "
          f"{k_ms:.3f} ms, plain {plain:.1f} ms, bound {bnd_p['bound_ms']:.4f} ms")
    return out


def phase_final_exp(ctx):
    import numpy as np
    import torch

    from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn
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
    per_lane = count_fp_muls(lambda: PR.final_exp(lane_cpu(f, 4)))  # the work is data-independent
    out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "shape": [16, 12, ctx.batch],
           **bound(per_lane * ctx.batch, nbytes(f, got))}
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
    out["bound_ms_b1"] = bound(per_lane, nbytes(one, got))["bound_ms"]
    print(f"K4 final_exp B=1: exact vs plain, oracle ok; kernel {out['ms_b1']:.3f} ms, "
          f"plain {out['plain_ms_b1']:.1f} ms")
    return out


def miller_product_inputs(ctx, n):
    """n (P, Q) pairs per lane from the pools. About half the lanes put
    one pair's P or Q at infinity; edge lanes: 0 every P infinite, 1 the
    first Q infinite, 2 the last P infinite (in the second pass for n > 4),
    3 all finite, 4 the first pair infinite by its mask alone (its
    coordinates kept: the wrapper must zero them), 5 a pair and its
    negation on one Q (the product is one). Returns (ps, qs, masked):
    per-pair lane lists (None = infinity) and the mask-only lanes."""
    from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn

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
    from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn
    from snark_bn254_verifier_tpu_torch.models.packing import unpack_fq12
    from snark_bn254_verifier_tpu_torch.ops import pairing as PR
    from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC

    b = ctx.batch
    out = {"max_abs_err": 0, "shape": [3, 16, b]}
    # n = 3: Groth16's generic product; 2: PlonK's KZG check; 5: two passes
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
            # lane 3: every pair finite
            per_lane = count_fp_muls(lambda: PR.miller_product(*lane_cpu((P, Q), 3)))
            out.update(bound(per_lane * b, nbytes(*P, *Q, got)))
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
            out[f"bound_ms_b1_n{n}"] = bound(
                count_fp_muls(lambda: PR.miller_product(*lane_cpu(one, 0))),
                nbytes(*one[0], *one[1], got1))["bound_ms"]
            print(f"K5 miller_product n={n} B=1 (lane 3): exact vs plain and vs the batch; "
                  f"kernel {out[f'ms_b1_n{n}']:.3f} ms, plain {out[f'plain_ms_b1_n{n}']:.1f} ms")
    return out


MSM_N = 1 << 16  # the JAX package's large-MSM bench size (bench.py:250-300)
MSM_SEED = 11     # and its seed


@functools.lru_cache(maxsize=None)
def trapdoor_inputs(n: int):
    """The large MSM's data (fixtures/msm_lanes.py, the bench's seed) packed
    for the kernels at batch one, on the card: (points, scalars, expected)."""
    import torch

    from snark_bn254_verifier_tpu_torch.fixtures.msm_lanes import trapdoor_msm
    from snark_bn254_verifier_tpu_torch.models.packing import pack_msm

    pts, scs, expected = trapdoor_msm(n, MSM_SEED)
    packed, sc = pack_msm(pts, scs)
    points = tuple(torch.as_tensor(a, device="cuda") for a in packed)
    return points, torch.as_tensor(sc, device="cuda"), expected


PIP_STAGES = ("digits", "sort", "buckets", "merge", "reduction")
PIP_CHUNKS = (16, 32, 48, 64, 96, 128)  # the bucket stage's chunk lengths timed at 2^16
# msm_best's switch, both sides timed: (points, lanes)
SWITCH_SHAPES = ((16, 1), (32, 1), (64, 1), (128, 1), (256, 1), (4096, 1),
                 (16, 32), (64, 32), (256, 32),
                 (16, BATCH), (64, BATCH), (256, BATCH), (1024, BATCH))


def pippenger_attrs(lib) -> dict:
    """Registers, stack bytes, threads a block and resident blocks an SM
    of each K6 stage (cudaFuncGetAttributes, cudaOccupancy...)."""
    import ctypes

    from snark_bn254_verifier_tpu_torch.ops import _build

    stages, comb = (ctypes.c_int * 20)(), (ctypes.c_int * 4)()
    _build.check(lib, lib.bn_msm_pippenger_stage_attrs(stages), "bn_msm_pippenger_stage_attrs")
    _build.check(lib, lib.bn_msm_pippenger_combine_attrs(comb), "bn_msm_pippenger_combine_attrs")
    vals = list(stages) + list(comb)
    return {stage: {"registers": vals[4 * i], "stack_bytes": vals[4 * i + 1],
                    "threads_per_block": vals[4 * i + 2], "blocks_per_sm": vals[4 * i + 3]}
            for i, stage in enumerate(PIP_STAGES + ("combine",))}


def phase_msm_pippenger(ctx):
    """K6: exact against its plain twin, K2 and the oracle at N = 256 over
    four lanes with edge lanes (both timed there), and against the closed
    form at N = 2^16, timed there with its bound, its stages timed apart
    (CUDA events), each chunk length of PIP_CHUNKS exact and timed, and
    its halves (window sums, then the combine) exact; then K2 against K6
    at SWITCH_SHAPES, msm_best's switch."""
    import numpy as np
    import torch

    from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn
    from snark_bn254_verifier_tpu_torch.models.packing import pack_g1, unpack_g1
    from snark_bn254_verifier_tpu_torch.ops import _build
    from snark_bn254_verifier_tpu_torch.ops import msm as M
    from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC
    from snark_bn254_verifier_tpu_torch.ops.limbs import limbs_batch_to_ints

    def on_card(pts, sc):
        packed = [pack_g1(p) for p in pts]
        return (tuple(torch.as_tensor(np.stack([p[i] for p in packed]), device=ctx.dev)
                      for i in range(3)), torch.as_tensor(sc, device=ctx.dev))

    # N = 256 over 4 lanes: lane 0 every scalar zero (infinity), lane 1 one
    # point throughout (each bucket adds P + P), lanes 2-3 with points at
    # infinity and zero scalars among them
    n, b = 256, 4
    pts, sc = msm_inputs(ctx, n, p_inf=0.1, p_zero=0.1, b=b)
    sc[:, :, 0] = 0
    for j in range(n):
        pts[j][1] = ctx.g1_pool[0]
    args = on_card(pts, sc)
    got = PC.msm_pippenger(*args)
    want, plain_ms = time_plain(lambda: M.pippenger_plain(*args))
    err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]),
              int((got[2] != want[2]).sum().item()))
    require(err == 0, "msm_pippenger (N=256) differs from its plain twin")
    require(all(torch.equal(g, k) for g, k in zip(got, PC.msm_affine(*args))),
            "msm_pippenger (N=256) != K2")
    got_pts = unpack_g1(*got)
    for lane in range(b):
        keep = [j for j in range(n) if pts[j][lane] is not None]
        want_pt = bn.g1_msm([pts[j][lane] for j in keep],
                            [limbs_batch_to_ints(sc[j][:, lane:lane + 1])[0] for j in keep])
        require(got_pts[lane] == want_pt, f"msm_pippenger (N=256) lane {lane} != oracle")
    require(got_pts[0] is None, "msm_pippenger: all-zero scalars must give infinity")
    ms_256 = time_kernel(lambda: PC.msm_pippenger(*args), 3)
    print(f"K6 msm_pippenger N={n} B={b}: exact vs plain, K2 and oracle; kernel "
          f"{ms_256:.3f} ms, plain {plain_ms:.1f} ms")

    # N = 2^16 at batch one (the bench's trapdoor points): the closed form,
    # then timed (all six launches), its stages apart, each chunk length
    points, scal, expected = trapdoor_inputs(MSM_N)
    PC.reset_launch_counts()
    got = PC.msm_pippenger(points, scal)
    require(PC.launch_counts()["msm_pippenger"] == 1, "msm_pippenger did not launch")
    require(unpack_g1(*got)[0] == expected, "msm_pippenger (N=2^16) != closed form")
    ms = time_kernel(lambda: PC.msm_pippenger(points, scal), 5)
    ws = PC.msm_pippenger_windows(points, scal)
    require(unpack_g1(*PC.msm_pippenger_combine(ws.unsqueeze(0)))[0] == expected,
            "msm_pippenger_windows + msm_pippenger_combine (N=2^16) != closed form")
    runs = []
    for _ in range(5):
        runs.append([])
        PC.msm_pippenger_windows(points, scal, stage_ms=runs[-1])
    stage_ms = {st: float(np.mean([r[i] for r in runs])) for i, st in enumerate(PIP_STAGES)}
    stage_ms["combine"] = time_kernel(lambda: PC.msm_pippenger_combine(ws.unsqueeze(0)), 5)
    chunk_ms = {}
    for chunk in PIP_CHUNKS:
        require(unpack_g1(*PC.msm_pippenger(points, scal, chunk=chunk))[0] == expected,
                f"msm_pippenger (N=2^16, chunk {chunk}) != closed form")
        chunk_ms[chunk] = time_kernel(lambda: PC.msm_pippenger(points, scal, chunk=chunk), 5)
    bnd = bound(pippenger_work(points, scal, 8), nbytes(*points, scal, *got))
    stages = pippenger_attrs(_build.load_kernels().lib)
    print(f"K6 msm_pippenger N=2^16 B=1 c=8: exact vs closed form; {ms:.3f} ms, bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); stages (CUDA events) "
          + ", ".join(f"{k} {v:.4f}" for k, v in stage_ms.items()) + " ms; chunk "
          + ", ".join(f"{k}: {v:.3f}" for k, v in chunk_ms.items()) + " ms")
    for stage, a in stages.items():
        print(f"K6 stage {stage}: {a['registers']} registers, {a['stack_bytes']} B stack, "
              f"{a['threads_per_block']} threads a block, {a['blocks_per_sm']} resident "
              f"blocks an SM")
    out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "stage_ms": stage_ms,
           "chunk": PC.PIPPENGER_CHUNK, "chunk_ms": chunk_ms, "stages": stages,
           "ms_n256_b4": ms_256, "shape": [MSM_N, 16, 1], "plain_shape": [n, 16, b], **bnd}

    # K2 against K6 at msm_best's switch: the trapdoor points at B = 1,
    # msm_inputs at the batch (zero scalars and points at infinity among
    # them, the new edge shapes); equal results, both timed
    for n_pts, lanes in SWITCH_SHAPES:
        if lanes == 1:
            args = (tuple(t[:n_pts] for t in points), scal[:n_pts])
        else:
            args = on_card(*msm_inputs(ctx, n_pts, p_inf=0.05, p_zero=0.05, b=lanes))
        require(all(torch.equal(u, v) for u, v in zip(PC.msm_pippenger(*args),
                                                      PC.msm_affine(*args))),
                f"K6 != K2 at n={n_pts} B={lanes}")
        k6_ms = time_kernel(lambda: PC.msm_pippenger(*args), 3)
        k2_ms = time_kernel(lambda: PC.msm_affine(*args), 3)
        out[f"k6_ms_n{n_pts}_b{lanes}"], out[f"k2_ms_n{n_pts}_b{lanes}"] = k6_ms, k2_ms
        print(f"K2 vs K6 n={n_pts} B={lanes}: equal; K6 {k6_ms:.3f} ms, K2 {k2_ms:.3f} ms")
        if (n_pts, lanes) == (64, ctx.batch):  # where K6's reduction sets its time
            split = []
            PC.msm_pippenger_windows(*args, stage_ms=split)
            out["stage_ms_n64_batch"] = dict(zip(PIP_STAGES, split))
            print("K6 n=64 at the batch, stages (CUDA events): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in zip(PIP_STAGES, split)) + " ms")
    return out


# One on-card phase per entry of KERNEL_ENTRY_POINTS (checked by
# tests/test_torch_kernel_registry.py).
KERNEL_PHASES = {
    "mont_mul": phase_mont_mul,
    "g2_on_curve": phase_g2_on_curve,
    "msm_affine": phase_msm_affine,
    "miller_mixed": phase_miller_mixed,
    "final_exp": phase_final_exp,
    "miller_product": phase_miller_product,
    "msm_pippenger": phase_msm_pippenger,
}
# The kernels each path launches; together they cover KERNEL_ENTRY_POINTS
# but UNLAUNCHED, K1's elementwise form (its fused form runs on the slice).
SLICE_KERNELS = ("g2_on_curve", "msm_affine", "miller_mixed", "final_exp")
PLONK_BATCH_KERNELS = ("msm_affine", "miller_mixed", "final_exp")
SINGLE_KERNELS = ("msm_affine", "final_exp", "miller_product")
LARGE_MSM_KERNELS = ("msm_pippenger",)
UNLAUNCHED = ("mont_mul",)
PIPELINED = 8  # batches of each pipelined loop, at most two in flight (bench.py:105-116)


def pipelined(dispatch, expected, batches: int, what: str) -> float:
    """``batches`` calls of ``dispatch`` (a verify_batch_async), at most two
    in flight: the third is dispatched before the first is read, as the
    JAX package's bench does. Every batch's bools must equal ``expected``.
    Returns the seconds of the loop."""
    pending = []
    t0 = time.perf_counter()
    for _ in range(batches):
        pending.append(dispatch())
        if len(pending) > 2:
            require(pending.pop(0).cpu().tolist() == expected, f"{what}: a pipelined batch's bools")
    for ok in pending:
        require(ok.cpu().tolist() == expected, f"{what}: a pipelined batch's bools")
    return time.perf_counter() - t0


def run_slice(batch: int, iters: int):
    import numpy as np

    from snark_bn254_verifier_tpu_torch import Groth16BatchVerifier
    from snark_bn254_verifier_tpu_torch.fixtures.groth16_lanes import groth16_batch_lanes
    from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC

    vec, proofs, inputs, expected = groth16_batch_lanes(batch)
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
    require(launches["g2_on_curve"] == 1 and launches["mont_mul"] == 0,
            "the batched path must launch g2_on_curve once and mont_mul never")
    print(f"slice B={batch}: bool vector exact ({int(ok.sum())} True), launches {launches}")

    # the same small batch on the CPU (plain twins) gives the same answer
    small = 16
    cpu = Groth16BatchVerifier(vec.vk, device="cpu").verify_batch(proofs[:small], inputs[:small])
    require(cpu.tolist() == ok[:small].tolist(), "CUDA and CPU runs disagree on the first 16 lanes")
    print(f"slice: first {small} lanes equal to the CPU run")
    # set-up outside the timed runs: the second stream of the verifier's
    # ring and its pinned staging buffer (parallel/batch.py::_Ring)
    require(ver.verify_batch(proofs, inputs).tolist() == expected, "slice bool vector changed")

    times, stages = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        ok = ver.verify_batch(proofs, inputs)
        times.append(time.perf_counter() - t0)
        stages.append(ver.last_stats.extra["stage_ms"])
        require(ok.tolist() == expected, "slice bool vector changed between runs")
    best = min(times)
    mean_stage = {k: sum(s[k] for s in stages) / len(stages) for k in stages[0]}
    mean_stage["host_ms"] = sum(mean_stage[k] for k in ("parse_ms", "pack_ms", "upload_ms"))
    print(f"slice warm: {iters} runs, batch s {[round(t, 4) for t in times]}, "
          f"{batch / best:.1f} proofs/s (best), {batch * iters / sum(times):.1f} proofs/s (mean)")
    print("slice stage ms (mean): " + json.dumps({k: round(v, 3) for k, v in mean_stage.items()}))

    # pipelined: verify_batch_async, two batches in flight on their streams
    PC.reset_launch_counts()
    secs = pipelined(lambda: ver.verify_batch_async(proofs, inputs), expected, PIPELINED,
                     "slice")
    piped = PC.launch_counts()
    want = {name: PIPELINED if name in SLICE_KERNELS else 0 for name in PC.KERNEL_ENTRY_POINTS}
    require(piped == want, f"pipelined slice launches {piped}, expected {want}")
    print(f"slice pipelined: {PIPELINED} batches through verify_batch_async, bools exact, "
          f"one launch each of {', '.join(SLICE_KERNELS)} a batch; "
          f"{batch * PIPELINED / secs:.1f} proofs/s (synchronous: {batch / best:.1f} best, "
          f"{batch * iters / sum(times):.1f} mean)")
    return launches, piped


def run_plonk_batch(batch: int, iters: int):
    """The PlonK batch on the card: the exact bool vector, per batch three
    K2 launches, one fixed-only K3, one K4 and no other launch; the first
    8 lanes equal to the CPU run; then warm batches timed."""
    import numpy as np

    from snark_bn254_verifier_tpu_torch import PlonkBatchVerifier
    from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC

    vec, proofs, inputs, expected = plonk_inputs(batch)
    want = {name: 0 for name in PC.KERNEL_ENTRY_POINTS}
    want.update(msm_affine=3, miller_mixed=1, final_exp=1)
    ver = PlonkBatchVerifier(vec.vk, device="cuda")
    ver._kzg_tables()  # once-per-VK host work, outside the counted run
    PC.reset_launch_counts()
    ok, calls = run_recorded(lambda: ver.verify_batch(proofs, inputs, rng=plonk_rng()))
    launches = PC.launch_counts()
    require(ok.tolist() == expected, f"PlonK batch bool vector wrong: False at "
            f"{np.flatnonzero(~ok).tolist()}, expected {[i for i, e in enumerate(expected) if not e]}")
    require(launches == want, f"PlonK batch launches {launches}, expected {want}")
    (mm,) = [args for name, args in calls if name == "miller_mixed"]
    require(mm[0] is None and mm[1] is None and len(mm[2]) == 2,
            "the PlonK batch's K3 launch has a variable pair")
    print(f"PlonK batch B={batch}: bool vector exact ({int(ok.sum())} True, "
          f"{batch - int(ok.sum())} bad lanes), launches {launches}, "
          f"packer {ver.last_stats.extra['packer']}")

    small = 8
    cpu = PlonkBatchVerifier(vec.vk, device="cpu").verify_batch(proofs[:small], inputs[:small],
                                                               rng=plonk_rng())
    require(cpu.tolist() == ok[:small].tolist(),
            f"PlonK batch: CUDA and CPU runs disagree on the first {small} lanes")
    print(f"PlonK batch: first {small} lanes equal to the CPU run")
    # set-up outside the timed runs: the ring's second stream and buffer
    require(ver.verify_batch(proofs, inputs).tolist() == expected,
            "PlonK batch bool vector changed between runs")

    times, stages = [], []
    for _ in range(iters):
        PC.reset_launch_counts()
        t0 = time.perf_counter()
        ok = ver.verify_batch(proofs, inputs)
        times.append(time.perf_counter() - t0)
        require(ok.tolist() == expected, "PlonK batch bool vector changed between runs")
        require(PC.launch_counts() == want, "PlonK batch launches changed between runs")
        stages.append(ver.last_stats.extra["stage_ms"])
    best = min(times)
    mean_stage = {k: sum(s[k] for s in stages) / len(stages) for k in stages[0]}
    mean_stage["host_ms"] = sum(mean_stage[k] for k in (
        "parse_ms", "host_a_ms", "pack_a_ms", "upload_a_ms", "digest_copy_ms", "host_b_ms",
        "pack_b_ms", "upload_b_ms"))
    mean_stage["kernel_stages_ms"] = sum(mean_stage[k] for k in (
        "msm_a_ms", "msm_b_ms", "miller_ms", "final_exp_ms", "compare_ms"))
    print(f"PlonK batch warm: {iters} runs, batch s {[round(t, 4) for t in times]}, "
          f"{batch / best:.1f} proofs/s (best), {batch * iters / sum(times):.1f} proofs/s (mean)")
    print("PlonK batch stage ms (mean): "
          + json.dumps({k: round(v, 3) for k, v in mean_stage.items()}))

    # pipelined: phase A waits for its digests, phase B stays in flight
    PC.reset_launch_counts()
    secs = pipelined(lambda: ver.verify_batch_async(proofs, inputs), expected, PIPELINED,
                     "PlonK batch")
    piped = PC.launch_counts()
    require(piped == {k: v * PIPELINED for k, v in want.items()},
            f"pipelined PlonK launches {piped}, expected {want} a batch")
    print(f"PlonK batch pipelined: {PIPELINED} batches through verify_batch_async, bools "
          f"exact, {want['msm_affine']} / {want['miller_mixed']} / {want['final_exp']} "
          f"launches of msm_affine / miller_mixed / final_exp a batch; "
          f"{batch * PIPELINED / secs:.1f} proofs/s (synchronous: {batch / best:.1f} best, "
          f"{batch * iters / sum(times):.1f} mean)")
    return launches, piped


def run_large_msm(iters: int):
    """The large MSM through its entry points: TorchBackend.msm at 80
    points (K6 through msm_best, against the oracle), then sharded_msm on
    the bench's 2^16 trapdoor points over a world-size-1 NCCL group
    (exact against the closed form) and its wall clock, the port's
    counterpart of the JAX bench's msm_2e16_sharded_wallclock on one
    card. Returns the launches of both."""
    import statistics

    import torch
    import torch.distributed as dist

    from snark_bn254_verifier_tpu_torch import TorchBackend
    from snark_bn254_verifier_tpu_torch.fixtures.msm_lanes import trapdoor_msm
    from snark_bn254_verifier_tpu_torch.models.packing import unpack_g1
    from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC
    from snark_bn254_verifier_tpu_torch.parallel.sharded import (free_port, init_distributed,
                                                                 make_mesh, sharded_msm)

    pts, scs, expected80 = trapdoor_msm(80, MSM_SEED)
    points, scal, expected = trapdoor_inputs(MSM_N)
    backend = TorchBackend("cuda")
    init_distributed(init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, model_parallelism=1)
        PC.reset_launch_counts()
        got80 = backend.msm(pts, scs)
        out = sharded_msm(mesh, points, scal)
        launches = PC.launch_counts()
        require(got80 == expected80, "TorchBackend.msm (80 points) != closed form")
        require(unpack_g1(*out)[0] == expected, "sharded_msm (2^16, world 1) != closed form")
        require(launches["msm_pippenger"] == 3 and launches["msm_affine"] == 0,
                f"large MSM launches {launches}: K6 three times (the backend's MSM; the "
                f"shard's window sums and their combine), K2 never")
        backend_ms = []
        for _ in range(iters):
            t0 = time.perf_counter()
            backend.msm(pts, scs)  # ends in a copy to the host
            backend_ms.append((time.perf_counter() - t0) * 1e3)
        times = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sharded_msm(mesh, points, scal)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        dist.destroy_process_group()
    print(f"large MSM: TorchBackend.msm at 80 points and sharded_msm at 2^16 on a "
          f"world-size-1 NCCL group exact; launches {launches}; TorchBackend.msm at 80 points "
          f"over {iters} calls: median {statistics.median(backend_ms):.3f} ms; sharded_msm "
          f"wall clock over {iters} calls: median {statistics.median(times):.3f} ms, best "
          f"{min(times):.3f} ms")
    return launches


# The port's bench at its --smoke sizes; ``scaling`` starts a process a card
# and is left to the bench's own run.
BENCH_SMOKE = {"batch_size": 32, "iters": 2, "log2n": 10}
# the JAX bench's metric names (bench.py), at 2^10 MSM points
JAX_BENCH_METRICS = {
    "groth16_batch": "groth16_batched_verify_throughput",
    "plonk_batch": "plonk_batched_verify_throughput",
    "msm": "msm_2e10_sharded_wallclock",
    "mixed": "mixed_groth16_plonk_throughput",
    "groth16_single": "groth16_single_verify_latency",
    "plonk_single": "plonk_single_verify_latency",
    "kernel_validation": "kernel_validation",  # the JAX bench's pallas_validation
}
BENCH_KERNELS = {"groth16_batch": SLICE_KERNELS, "msm": LARGE_MSM_KERNELS}


def run_bench():
    """The port's bench in process on the card at its smoke sizes: each
    config but ``scaling`` through ``bench.RUNNERS``, its launches counted
    from 0. Returns the launches of every config but kernel_validation."""
    from snark_bn254_verifier_tpu_torch import bench
    from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC

    run = bench.Run(device="cuda", card=bench.card_fields("cuda"), **BENCH_SMOKE)
    require([c for c in bench.ORDER if c != "scaling"] == list(JAX_BENCH_METRICS),
            "the bench's configs changed")
    launches = {}
    for name, metric in JAX_BENCH_METRICS.items():
        PC.reset_launch_counts()
        line = bench.RUNNERS[name](run)
        launches[name] = PC.launch_counts()
        print("bench " + json.dumps(line))
        require("error" not in line and line["platform"] == "cuda" and line["metric"] == metric,
                f"bench {name}: {line}")
        if name == "kernel_validation":
            covered = set().union(*bench.KERNEL_VALIDATION_COVERAGE.values())
            require(line["value"] == 1 and covered == set(PC.KERNEL_ENTRY_POINTS),
                    f"bench kernel_validation: {line['stages']}")
    for name, kernels in BENCH_KERNELS.items():
        require(all(launches[name][k] for k in kernels),
                f"bench {name} launched {launches[name]}, not all of {kernels}")
    del launches["kernel_validation"]  # comparison launches, not a path's
    return launches


def outcome(fn):
    """("ok", result) or ("raises", error class, message) of fn(), for the
    reference's error taxonomy; any other exception fails the run."""
    from snark_bn254_verifier_tpu_torch.utils.errors import VerifierError

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
    from snark_bn254_verifier_tpu_torch.fixtures.gen import (
        gen_groth16_vector_sp1_shaped,
        gen_plonk_vector,
    )
    from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn
    from snark_bn254_verifier_tpu_torch.utils import serialization as ser

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


def oracle_verify(proto, proof, vk, inputs):
    """The protocol code on the oracle backend: the reference answer."""
    from snark_bn254_verifier_tpu_torch.models.groth16 import verify_groth16
    from snark_bn254_verifier_tpu_torch.models.plonk import verify_plonk
    from snark_bn254_verifier_tpu_torch.utils import serialization as ser

    if proto == "groth16":
        return verify_groth16(ser.load_groth16_verifying_key_from_bytes(vk),
                              ser.load_groth16_proof_from_bytes(proof), inputs, backend="oracle")
    return verify_plonk(ser.load_plonk_verifying_key_from_bytes(vk),
                        ser.load_plonk_proof_from_bytes(proof), inputs, backend="oracle")


def split_call(proto, proof, vk, inputs):
    """Host ms of one warm call of the shared protocol code, and of each
    primitive it made (msm: K2, pairing: K5 + K4, each with its packing
    and its copy back)."""
    import torch

    from snark_bn254_verifier_tpu_torch.models.groth16 import PreparedVerifyingKey, verify_groth16
    from snark_bn254_verifier_tpu_torch.models.plonk import verify_plonk
    from snark_bn254_verifier_tpu_torch.utils import serialization as ser
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

    from snark_bn254_verifier_tpu_torch import Groth16Verifier, PlonkVerifier
    from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC

    port = {"groth16": Groth16Verifier, "plonk": PlonkVerifier}
    cases = single_cases()
    PC.reset_launch_counts()
    got = [outcome(lambda c=c: port[c[0]].verify(*c[2:], device="cuda")) for c in cases]
    launches = PC.launch_counts()
    for (proto, label, proof, vk, ins), g in zip(cases, got):
        want = outcome(lambda: oracle_verify(proto, proof, vk, ins))
        require(g == want, f"single {proto} ({label}): cuda {g} != oracle {want}")
        print(f"single {proto} ({label}): {g[0]} {g[1]}, equal to the oracle backend")
    for name in SINGLE_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched by the single-proof path")
    print(f"single: launches {launches}")

    per_call = {}
    for proto in ("groth16", "plonk"):
        _, _, proof, vk, ins = next(c for c in cases if c[0] == proto)
        PC.reset_launch_counts()  # one warm good call's launches
        require(port[proto].verify(proof, vk, ins, device="cuda") is True,
                f"single {proto}: a warm call did not verify")
        per_call[f"{proto}_single"] = PC.launch_counts()
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
    print(f"single: launches per warm call {per_call}")
    return launches, per_call


def kernel_attrs(lib) -> dict:
    """Registers, stack (local) bytes and shared bytes per thread block of
    each kernel, from cudaFuncGetAttributes; the team kernels K2-K5 also
    report their team shape (csrc/msm.cuh, csrc/team.cuh)."""
    import ctypes

    from snark_bn254_verifier_tpu_torch.ops import _build
    from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC

    out = {}
    for name in PC.KERNEL_ENTRY_POINTS:
        vals = (ctypes.c_int * 6)()
        _build.check(lib, getattr(lib, f"bn_{name}_attrs")(vals), f"bn_{name}_attrs")
        out[name] = {"registers": vals[0], "stack_bytes": vals[1],
                     "shared_bytes_per_block": vals[2] + vals[3]}
        if name in TEAM_KERNELS:
            out[name]["team"] = {"threads_per_lane": vals[4], "lanes_per_block": vals[5]}
    return out


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
        if "Compiling entry" in line or "Used" in line or "done after" in line:
            print("  " + line.strip())
    require(set(KERNEL_PHASES) == set(PC.KERNEL_ENTRY_POINTS), "a kernel has no phase")

    ctx = Ctx(BATCH, SEED)
    results = {name: KERNEL_PHASES[name](ctx) for name in PC.KERNEL_ENTRY_POINTS}
    slice_launches, slice_piped = run_slice(BATCH, ITERS)
    plonk_launches, plonk_piped = run_plonk_batch(BATCH, ITERS)
    single_launches, per_call = run_single(SINGLE_ITERS)
    msm_launches = run_large_msm(ITERS)
    bench_launches = run_bench()
    per_call["slice"] = slice_launches  # one call of verify_batch
    per_call["plonk_batch"] = plonk_launches  # one call of PlonkBatchVerifier.verify_batch
    per_call["slice_pipelined"] = slice_piped  # PIPELINED calls of verify_batch_async
    per_call["plonk_pipelined"] = plonk_piped
    per_call["large_msm"] = msm_launches  # TorchBackend.msm (80 points) + sharded_msm (2^16)
    per_call.update({f"bench_{name}": n for name, n in bench_launches.items()})
    paths = (slice_launches, plonk_launches, single_launches, msm_launches, slice_piped,
             plonk_piped, *bench_launches.values())
    launches = {name: sum(p[name] for p in paths) for name in PC.KERNEL_ENTRY_POINTS}
    require(set(SLICE_KERNELS) | set(PLONK_BATCH_KERNELS) | set(SINGLE_KERNELS)
            | set(LARGE_MSM_KERNELS) == set(PC.KERNEL_ENTRY_POINTS) - set(UNLAUNCHED),
            "a kernel is launched by no path")
    require(all(launches[name] for name in LARGE_MSM_KERNELS), "the large MSM launched no K6")
    require(not any(launches[name] for name in UNLAUNCHED), "mont_mul was launched by a path")

    attrs = kernel_attrs(kl.lib)
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCE[name],
            "replaces": REPLACES[name][0],
            "also_replaces": REPLACES[name][1:],
            "launches": launches[name],
            "launches_per_call": {path: n[name] for path, n in per_call.items()},
            "max_abs_err": results[name]["max_abs_err"],
            "ms": results[name]["ms"],
            "plain_ms": results[name]["plain_ms"],
            "bound_ms": results[name]["bound_ms"],
            "bound_by": results[name]["bound_by"],
            "share_of_bound": results[name]["bound_ms"] / results[name]["ms"],
            # no PyTorch call computes a Montgomery product, the G2
            # on-curve mask, an MSM over BN254 (small or bucketed), a
            # Miller loop or a final exponentiation
            "library_ms": None,
            **attrs[name],
            **{k: v for k, v in results[name].items()
               if k not in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
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

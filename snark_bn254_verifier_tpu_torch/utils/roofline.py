"""Roofline accounting: Montgomery products per verification, and the
H100's peaks.

The counterpart of snark_bn254_verifier_tpu/utils/roofline.py, with the
same public functions and the same meaning for each. It answers "is N
proofs/s fast?" by turning a measured rate into Montgomery products a
second and comparing them with the card's integer multiply-add peak.

Counting: leaf costs (one Miller step, one Jacobian double, one Fq12
multiply, ...) are counted by running the port's plain twins
(ops/{tower,curve,pairing}.py) at B = 1 on CPU tensors with a counting
wrapper around ``ops/field.mont_mul``: each call adds the element count of
its broadcast batch, so the wide tower products are charged their true
totals. Loop multiplicities come from the port's schedule constants
(``ops/lines.py::MILLER_BITS``, ``ops/pairing.py::X_BITS``). The totals
mean what the JAX totals mean: every step is charged both branches (a
Miller step its doubling and its addition, an exponentiation by x its
squaring and its multiply for every bit, a curve addition its doubling
fallback, as the JAX package's selects pay them), and a Fermat
``pow_const`` 2 products a bit of its exponent. So
``groth16_mults_per_proof(2)`` reads 50,866 here as there. These totals
count more than the card computes on real data (the twins, and the
kernels after them, skip the zero bits and the doubling branch where no
lane needs it). What a lane computes is ``lane_mults`` (37,987 for the
bench's Groth16 proof), counted as the kernel bounds (``count_fp_muls``,
``bound``) count: the card's share of its peak is
``pct_imad_roofline_computed``, and ``pct_imad_roofline`` keeps the JAX
meaning.

The card (NVIDIA's H100 SXM data sheet and the CUDA Programming Guide's
throughput table for compute capability 9.0): 64 32-bit integer
multiply-adds a clock per SM, 132 SMs, 1.98 GHz boost, 3.35 TB/s of
device memory. One product (csrc/fp.cuh::fp_mul, CIOS on 8 x 32-bit
limbs) is 264 multiply-adds. Adds, subtracts and selects are not
counted, so the roofline share is an underestimate.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager

# The card's peaks (see the module docstring).
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 64 * 132 * 1.98e9
# CIOS on 8 x 32-bit limbs (csrc/fp.cuh::fp_mul): 64 a_i b_j and 64 m p_j
# wide products, each a lo and a hi multiply-add, and 8 m = t0 n0' products
IMAD_PER_FP_MUL = 2 * (64 + 64) + 8


@contextmanager
def _counting(charge_pow: bool):
    """Count the Montgomery products made inside the block; with
    ``charge_pow`` a ``pow_const`` is charged 2 products a bit of its
    exponent and not run (its value is then wrong: count only)."""
    from ..ops import field as F

    total = [0]
    real_mul, real_pow = F.mont_mul, F.pow_const

    def counting_mul(spec, a, b):
        out = real_mul(spec, a, b)
        total[0] += out[0].numel()
        return out

    def charged_pow(spec, a, exponent: int):
        total[0] += 2 * exponent.bit_length() * a[0].numel()
        return a

    F.mont_mul = counting_mul
    if charge_pow:
        F.pow_const = charged_pow
    try:
        yield total
    finally:
        F.mont_mul, F.pow_const = real_mul, real_pow


def count_fp_muls(fn) -> int:
    """Montgomery products the plain twins make in fn() on CPU tensors: the
    work of the per-lane formulas, which the kernels share (K3 and K4
    compute more products than that on their teams; the bound counts what
    the function needs)."""
    with _counting(charge_pow=False) as total:
        fn()
    return total[0]


def bound(fp_muls: int, nbytes: int) -> dict:
    """The least time the card could take for ``fp_muls`` Montgomery
    products reading and writing ``nbytes``: the larger of integer
    multiply-add issue and device memory."""
    ops_ms = fp_muls * IMAD_PER_FP_MUL / IMAD_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "fp_muls": fp_muls, "imads": fp_muls * IMAD_PER_FP_MUL, "bytes": nbytes}


def pippenger_work(points, scalars, c: int) -> int:
    """Montgomery products the bucket MSM (kernel K6) needs on these
    inputs, summed over lanes: a mixed add per finite point of nonzero
    digit and window, the running sums (two full adds a bucket and
    window), Horner (c doublings and an add a window) and the affine
    conversion; each operation's products counted on its plain formula
    (``count_fp_muls``). The merges of buckets split between the kernel's
    chunks and its teams' repeated work are not counted: the bound counts
    what the method needs, not what one design computes."""
    import torch

    from ..models.packing import pack_g1
    from ..ops import curve as C
    from ..ops import msm as M
    from ..oracle import bn254 as bn

    g1 = C.G1_OPS
    x, y, inf = (torch.as_tensor(a) for a in pack_g1([bn.G1_GEN]))
    x, y = x.to(torch.int64), y.to(torch.int64)
    q = C.jacobian_double(g1, C.to_jacobian(g1, (x, y, inf)))  # 2G and 4G, Z != 1
    r = C.jacobian_double(g1, q)
    madd = count_fp_muls(lambda: C.jacobian_add_mixed(g1, q, (x, y, inf)))
    add = count_fp_muls(lambda: C.jacobian_add(g1, q, r))
    dbl = count_fp_muls(lambda: C.jacobian_double(g1, q))
    affine = count_fp_muls(lambda: C.to_affine(g1, q))
    digits = M._digits(scalars, c).masked_fill(points[2].to(torch.bool).unsqueeze(0), 0)
    nonzero = int((digits != 0).sum().item())
    w, b = M.windows(c), scalars.shape[-1]
    per_lane = w * 2 * ((1 << c) - 1) * add + (w - 1) * (c * dbl + add) + affine
    return nonzero * madd + b * per_lane


def _count(fn) -> int:
    """Products of fn(), every ``pow_const`` charged 2 a bit."""
    with _counting(charge_pow=True) as total:
        fn()
    return total[0]


def _sample_points():
    """B = 1 operands for the leaf ops, as the JAX module's: P = 7G, Q = 9G."""
    import torch

    from ..models.packing import pack_g1, pack_g2
    from ..oracle import bn254 as bn
    from ..ops import field as F
    from ..ops.limbs import FQ

    p = tuple(torch.as_tensor(a) for a in pack_g1([bn.g1_mul(bn.G1_GEN, 7)]))
    q = tuple(torch.as_tensor(a) for a in pack_g2([bn.g2_mul(bn.G2_GEN, 9)]))
    p = (p[0].long(), p[1].long(), p[2])
    q = (q[0].long(), q[1].long(), q[2])
    return p, q, F.one_mont(FQ, p[0])


@functools.lru_cache(maxsize=None)
def _leaf_costs() -> dict:
    """Per-lane product counts of every hot leaf op (B = 1), by the JAX
    module's leaf definitions. The curve additions add a point to itself,
    so the doubling fallback, which the twins pay only where a lane needs
    it, is charged as the JAX package's select charges it; ``fe_easy``
    keeps the JAX module's three Frobenius maps of the Straus bases."""
    import torch

    from ..ops import curve as C
    from ..ops import pairing as PR
    from ..ops import tower as T

    (px, py, pinf), (qx, qy, qinf), one = _sample_points()
    jac = (px, py, one)
    t_pt = (qx, qy, T.fq2_one(qx.shape[2:], qx))
    f12 = T.fq12_one(px.shape[1:], px)

    def miller_step():
        f = T.fq12_sq(f12)
        t, line = PR._dbl_step(t_pt)
        f = PR._mul_by_line(f, line, px, py)
        _, line2 = PR._add_step(t, (qx, qy))
        PR._mul_by_line(f, line2, px, py)

    def miller_tail():
        q1 = PR._g2_frobenius_affine((qx, qy), 1)
        q2 = PR._g2_frobenius_affine((qx, qy), 2)
        q2 = (q2[0], T.fq2_neg(q2[1]))
        t, line = PR._add_step(t_pt, q1)
        f = PR._mul_by_line(f12, line, px, py)
        _, line = PR._add_step(t, q2)
        PR._mul_by_line(f, line, px, py)

    def fe_easy():
        f = T.fq12_mul(T.fq12_conj(f12), T.fq12_inv(f12))
        T.fq12_mul(T.fq12_frobenius(f, 2), f)
        for i in range(1, 4):
            T.fq12_frobenius(f, i)  # the JAX module's 4 Straus bases

    def var_dbl_line():
        _, line = PR._dbl_step(t_pt)
        PR._mul_by_line(f12, line, px, py)

    def var_add_line():
        _, line = PR._add_step(t_pt, (qx, qy))
        PR._mul_by_line(f12, line, px, py)

    def fixed_line():
        row = torch.zeros((16, 2), dtype=torch.int64)
        PR._fixed_line_apply(f12, row, row, px, py, pinf)

    g1 = C.G1_OPS
    return {
        "miller_step": _count(miller_step),
        "miller_tail": _count(miller_tail),
        "var_dbl_line": _count(var_dbl_line),
        "var_add_line": _count(var_add_line),
        "fixed_line": _count(fixed_line),
        "fe_easy": _count(fe_easy),
        "fq12_mul": _count(lambda: T.fq12_mul(f12, f12)),
        "fq12_sq": _count(lambda: T.fq12_sq(f12)),
        "fq12_cyc_sq": _count(lambda: T.fq12_cyclotomic_sq(f12)),
        "frobenius": _count(lambda: T.fq12_frobenius(f12, 1)),
        "jac_double": _count(lambda: C.jacobian_double(g1, jac)),
        "jac_add_mixed": _count(lambda: C.jacobian_add_mixed(g1, jac, (px, py, pinf))),
        "jac_add_full": _count(lambda: C.jacobian_add(g1, jac, jac)),
        "to_affine": _count(lambda: C.to_affine(g1, jac)),
    }


def miller_loop_mults() -> int:
    """One Miller loop: the 64-step 6x+2 schedule, every step charged its
    doubling and its addition, and the Frobenius tail."""
    from ..ops.lines import MILLER_BITS

    c = _leaf_costs()
    return len(MILLER_BITS) * c["miller_step"] + c["miller_tail"]


def final_exp_mults() -> int:
    """The x-chain (ops/pairing.py::final_exponentiation): the easy part,
    three exponentiations by x (a cyclotomic squaring and a multiply a
    bit), and the combine (12 squarings, 18 multiplies, 3 Frobenius maps,
    counted from ``_fe_combine``)."""
    from ..ops.pairing import X_BITS

    c = _leaf_costs()
    exp_x = (len(X_BITS) - 1) * (c["fq12_cyc_sq"] + c["fq12_mul"])
    chain = 12 * c["fq12_cyc_sq"] + 18 * c["fq12_mul"] + 3 * c["frobenius"]
    return c["fe_easy"] + 3 * exp_x + chain


def pairing_product_mults(n_pairs: int) -> int:
    """An n-pair Miller product with one shared final exponentiation (K5
    then K4, the single-proof backend's pairing)."""
    c = _leaf_costs()
    return n_pairs * miller_loop_mults() + (n_pairs - 1) * c["fq12_mul"] + final_exp_mults()


def mixed_product_mults(nf: int, has_var: bool) -> int:
    """The shared-chain mixed Miller product and final exponentiation that
    both batch verifiers run (K3 then K4): one f squaring a step for the
    whole product, both line rows of the nf fixed pairs a step, the
    variable pair's G2 steps if any, and the tails."""
    from ..ops.lines import MILLER_BITS

    c = _leaf_costs()
    per_step = c["fq12_sq"] + 2 * nf * c["fixed_line"]
    if has_var:
        per_step += c["var_dbl_line"] + c["var_add_line"]
    tails = 2 * nf * c["fixed_line"] + (c["miller_tail"] if has_var else 0)
    return len(MILLER_BITS) * per_step + tails + final_exp_mults()


def straus_msm_mults(n_points: int) -> int:
    """Bit-serial shared-doubling Straus: 256 bits x (a double and n mixed
    adds). Kept for comparison, as in the JAX module."""
    c = _leaf_costs()
    return 256 * (c["jac_double"] + n_points * c["jac_add_mixed"])


def windowed_msm_mults(n_points: int, w: int = 4) -> int:
    """Windowed Straus (ops/curve.py::msm_windowed, K2): a table of 2^w - 2
    entries a point (charged as mixed adds, the upper bound), 256 shared
    doublings and one full add a point a window."""
    c = _leaf_costs()
    table = n_points * ((1 << w) - 2) * c["jac_add_mixed"]
    return table + 256 * c["jac_double"] + (256 // w) * n_points * c["jac_add_full"]


def groth16_mults_per_proof(n_inputs: int = 2) -> int:
    """One lane of the batched Groth16 path (parallel/batch.py): the
    (n_inputs + 1)-point MSM folding k0 in with scalar 1 and its affine
    form, then the mixed product with one variable and two fixed pairs."""
    c = _leaf_costs()
    return (windowed_msm_mults(n_inputs + 1) + c["to_affine"]
            + mixed_product_mults(nf=2, has_var=True))


def plonk_mults_per_proof(n_qcp: int = 0) -> int:
    """One lane of the PlonK batch: the linearisation MSM (10 + n_qcp
    points), the combo MSM (14 + n_qcp) and the quotient MSM (2), each to
    affine, then the fixed-only two-pair KZG product."""
    c = _leaf_costs()
    n_lin = 10 + n_qcp
    return (windowed_msm_mults(n_lin) + windowed_msm_mults(n_lin + 4)
            + windowed_msm_mults(2) + 3 * c["to_affine"]
            + mixed_product_mults(nf=2, has_var=False))


def lane_mults(verifier_cls, vk: bytes, proof: bytes, public_inputs) -> int:
    """Montgomery products that one lane of a batch verifier computes on
    this proof: a CPU instance of ``verifier_cls`` (parallel/batch.py)
    verifying it once on the plain twins, the per-lane work of the kernels
    it runs. Its set-up (line tables, e(alpha, beta)) runs on the oracle
    and is not counted."""
    ver = verifier_cls(vk, device="cpu")
    return count_fp_muls(lambda: ver.verify_batch([proof], [public_inputs]))


def _pct_peak(mults_per_sec: float) -> float:
    return round(100.0 * mults_per_sec * IMAD_PER_FP_MUL / IMAD_PER_S, 2)


def roofline_fields(proofs_per_sec_per_chip: float, mults_per_proof: int,
                    computed_mults_per_proof: int = None) -> dict:
    """Bench-line fields: the product rate and its share of the card's
    multiply-add peak, as the JAX package counts (both branches); with
    ``computed_mults_per_proof`` (``lane_mults``) also the share of what
    the card computes, ``pct_imad_roofline_computed``."""
    mults_per_sec = proofs_per_sec_per_chip * mults_per_proof
    fields = {
        "mults_per_proof": int(mults_per_proof),
        "mont_mults_per_sec": round(mults_per_sec, 1),
        "pct_imad_roofline": _pct_peak(mults_per_sec),
    }
    if computed_mults_per_proof is not None:
        fields["computed_mults_per_proof"] = int(computed_mults_per_proof)
        fields["pct_imad_roofline_computed"] = _pct_peak(
            proofs_per_sec_per_chip * computed_mults_per_proof)
    return fields

"""Plain PyTorch G1/G2 curve arithmetic, generic over the coordinate field.

The counterpart of the parts of snark_bn254_verifier_tpu/ops/curve.py that
the batched Groth16 path uses. Jacobian points are tuples (X, Y, Z) with
x = X/Z^2, y = Y/Z^3 and infinity encoded as Z == 0; affine points are
(x, y, inf) with a batch-shaped bool mask. Edge cases are handled by
selects, and every operation broadcasts over trailing batch axes.

``g2_on_curve`` is the plain twin of K1's fused form, the main path's G2
on-curve mask; ``msm_affine`` is the plain twin of kernel K2
(csrc/team_kernels.cu::msm_affine_kernel): the windowed shared-doubling MSM of the Pallas
kernels _msm_windowed_kernel + _jacobian_combine_kernel
(snark_bn254_verifier_tpu/ops/pairing_pallas.py:206,271), then affine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..oracle import bn254 as bn
from . import field as F
from . import tower as T
from .limbs import FQ, LIMB_BITS

MSM_WINDOW_W = 4  # digit width; divides 16 so a digit never spans limbs


@dataclass(frozen=True)
class CurveOps:
    """Field-op bundle and curve constant b, shared by G1 (Fq), G2 (Fq2)."""

    name: str
    add: Callable
    sub: Callable
    neg: Callable
    mul: Callable
    mul_many: Callable  # [(a, b), ...] -> [a*b, ...] in one wide product
    sq: Callable
    inv: Callable
    is_zero: Callable
    eq: Callable
    zero: Callable      # like -> 0
    one: Callable       # like -> mont(1)
    b_const: Callable   # like -> curve b (mont)

    def dbl_coord(self, a):
        return self.add(a, a)


def _fq_mul_many(pairs, fq_mul):
    t = fq_mul(torch.stack([a for a, _ in pairs], 1),
               torch.stack([b for _, b in pairs], 1))
    return [t[:, i] for i in range(len(pairs))]


G1_OPS = CurveOps(
    name="g1",
    add=F.fq_add,
    sub=F.fq_sub,
    neg=F.fq_neg,
    mul=F.fq_mul,
    mul_many=lambda pairs: _fq_mul_many(pairs, F.fq_mul),
    sq=F.fq_sq,
    inv=F.fq_inv,
    is_zero=F.is_zero,
    eq=F.eq,
    zero=torch.zeros_like,
    one=lambda like: F.one_mont(FQ, like),
    b_const=lambda like: torch.as_tensor(
        FQ.pack_scalar(bn.B_G1), dtype=like.dtype, device=like.device
    ).view((16,) + (1,) * (like.dim() - 1)),
)


G2_OPS = CurveOps(
    name="g2",
    add=T.fq2_add,
    sub=T.fq2_sub,
    neg=T.fq2_neg,
    mul=T.fq2_mul,
    mul_many=T.fq2_mul_many,
    sq=T.fq2_sq,
    inv=T.fq2_inv,
    is_zero=T.fq2_is_zero,
    eq=T.fq2_eq,
    zero=torch.zeros_like,
    one=lambda like: T.fq2_one(like.shape[2:], like),
    b_const=lambda like: T.fq2_pack_const(bn.B_G2, like),
)


def _sel(cond, a, b):
    """Select point tuples lane-wise."""
    return tuple(F.select(cond, x, y) for x, y in zip(a, b))


def to_jacobian(ops: CurveOps, affine):
    x, y, inf = affine
    return (x, y, F.select(inf, ops.zero(x), ops.one(x)))


def inf_point(ops: CurveOps, like):
    one = ops.one(like)
    return (one, one, ops.zero(like))


def jacobian_double(ops: CurveOps, p):
    """dbl-2009-l (a = 0); infinity stays infinity (Z3 = 2YZ = 0).
    Independent products share one Montgomery call per stage."""
    x, y, z = p
    a, b, yz = ops.mul_many([(x, x), (y, y), (y, z)])
    e = ops.add(ops.dbl_coord(a), a)
    xb = ops.add(x, b)
    c, xb2, f = ops.mul_many([(b, b), (xb, xb), (e, e)])
    d = ops.dbl_coord(ops.sub(ops.sub(xb2, a), c))
    x3 = ops.sub(f, ops.dbl_coord(d))
    c8 = ops.dbl_coord(ops.dbl_coord(ops.dbl_coord(c)))
    y3 = ops.sub(ops.mul(e, ops.sub(d, x3)), c8)
    return (x3, y3, ops.dbl_coord(yz))


def _fix_edges(ops, p, q, added, h, r):
    """Edge cases of an addition: p == q doubles, p == -q gives infinity,
    an infinite operand yields the other one."""
    h_zero, r_zero = ops.is_zero(h), ops.is_zero(r)
    dbl_case = h_zero & r_zero
    res = added
    if bool(dbl_case.any()):  # the doubling is paid only where a lane needs it
        res = _sel(dbl_case, jacobian_double(ops, p), added)
    inf_case = h_zero & ~r_zero
    res = (res[0], res[1], F.select(inf_case, ops.zero(res[2]), res[2]))
    res = _sel(ops.is_zero(p[2]), q, res)
    return _sel(ops.is_zero(q[2]), p, res)


def jacobian_add_mixed(ops: CurveOps, p, q_affine):
    """p (Jacobian) + q (affine with mask): madd-2007-bl, full edge cases."""
    x1, y1, z1 = p
    xq, yq, _ = q_affine
    z1z1, yqz1 = ops.mul_many([(z1, z1), (yq, z1)])
    u2, s2 = ops.mul_many([(xq, z1z1), (yqz1, z1z1)])
    h = ops.sub(u2, x1)
    r = ops.sub(s2, y1)
    rr = ops.dbl_coord(r)
    hh, rr2 = ops.mul_many([(h, h), (rr, rr)])
    i = ops.dbl_coord(ops.dbl_coord(hh))
    j, v, z3 = ops.mul_many([(h, i), (x1, i), (ops.dbl_coord(z1), h)])
    x3 = ops.sub(ops.sub(rr2, j), ops.dbl_coord(v))
    y3a, y1j = ops.mul_many([(rr, ops.sub(v, x3)), (y1, j)])
    y3 = ops.sub(y3a, ops.dbl_coord(y1j))
    return _fix_edges(ops, p, to_jacobian(ops, q_affine), (x3, y3, z3), h, r)


def jacobian_add(ops: CurveOps, p, q):
    """Jacobian + Jacobian: add-2007-bl, full edge cases."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2, y1z2, y2z1, z1z2 = ops.mul_many(
        [(z1, z1), (z2, z2), (y1, z2), (y2, z1), (z1, z2)]
    )
    u1, u2, s1, s2 = ops.mul_many(
        [(x1, z2z2), (x2, z1z1), (y1z2, z2z2), (y2z1, z1z1)]
    )
    h = ops.sub(u2, u1)
    r = ops.sub(s2, s1)
    h2 = ops.dbl_coord(h)
    rr = ops.dbl_coord(r)
    i, rr2 = ops.mul_many([(h2, h2), (rr, rr)])
    j, v, z3 = ops.mul_many([(h, i), (u1, i), (ops.dbl_coord(z1z2), h)])
    x3 = ops.sub(ops.sub(rr2, j), ops.dbl_coord(v))
    y3a, s1j = ops.mul_many([(rr, ops.sub(v, x3)), (s1, j)])
    y3 = ops.sub(y3a, ops.dbl_coord(s1j))
    return _fix_edges(ops, p, q, (x3, y3, z3), h, r)


def to_affine(ops: CurveOps, p):
    """Jacobian -> (x, y, inf); infinity maps to (0, 0, True)."""
    x, y, z = p
    inf = ops.is_zero(z)
    zinv = ops.inv(F.select(inf, ops.one(z), z))
    zinv2 = ops.sq(zinv)
    ax = ops.mul(x, zinv2)
    ay = ops.mul(y, ops.mul(zinv, zinv2))
    zero = ops.zero(x)
    return (F.select(inf, zero, ax), F.select(inf, zero, ay), inf)


def is_on_curve_affine(ops: CurveOps, affine):
    x, y, inf = affine
    lhs = ops.sq(y)
    rhs = ops.add(ops.mul(ops.sq(x), x), ops.b_const(x))
    return inf | ops.eq(lhs, rhs)


def g2_on_curve(bs, valid):
    """valid & (inf | y^2 == x^3 + b') of affine G2 points: the plain twin
    of the fused K1 (ops/pairing_cuda.py::g2_on_curve)."""
    return valid & is_on_curve_affine(G2_OPS, bs)


def msm_windowed(ops: CurveOps, points, scalars, w: int = MSM_WINDOW_W):
    """Windowed shared-doubling (Straus) MSM, as the Pallas kernel computes
    it: a 2^w-entry Jacobian table per point (even entries by doubling,
    odd ones by a mixed add), then per w-bit window, high first, w shared
    doublings and one full add per point of its table entry; digit 0 reads
    the infinity entry, which the add absorbs.

    points: (x (n,16,*b), y (n,16,*b), inf (n,*b)) affine; scalars
    (n,16,*b) canonical Fr limbs. Returns Jacobian coords (16,*b)."""
    if LIMB_BITS % w:
        raise ValueError("window width must divide the limb width")
    x, y, inf = points
    n = x.shape[0]
    aff = (x.movedim(0, 1), y.movedim(0, 1), inf)  # coords (16, n, *b)
    tbl = [inf_point(ops, aff[0]), to_jacobian(ops, aff)]
    for d in range(2, 1 << w):
        tbl.append(
            jacobian_double(ops, tbl[d // 2])
            if d % 2 == 0
            else jacobian_add_mixed(ops, tbl[d - 1], aff)
        )
    tabs = [torch.stack([t[c] for t in tbl], 0) for c in range(3)]
    acc = inf_point(ops, aff[0][:, 0])
    nwin = 256 // w
    for k in range(nwin):
        limb, shift = divmod((nwin - 1 - k) * w, LIMB_BITS)
        for _ in range(w):
            acc = jacobian_double(ops, acc)
        dig = (scalars[:, limb].to(torch.int64) >> shift) & ((1 << w) - 1)
        idx = dig.unsqueeze(0).unsqueeze(0).expand((1,) + tabs[0].shape[1:])
        ent = [tab.gather(0, idx)[0] for tab in tabs]  # (16, n, *b)
        for j in range(n):
            acc = jacobian_add(ops, acc, tuple(e[:, j] for e in ent))
    return acc


def msm_affine(points, scalars):
    """Plain twin of kernel K2: sum_j scalars[j] * points[j] per lane, in
    affine form (x (16,*b) int32, y, inf (*b) bool)."""
    x, y, inf = points
    pts = (x.to(torch.int64), y.to(torch.int64), inf.to(torch.bool))
    ax, ay, ainf = to_affine(G1_OPS, msm_windowed(G1_OPS, pts, scalars))
    return ax.to(torch.int32), ay.to(torch.int32), ainf

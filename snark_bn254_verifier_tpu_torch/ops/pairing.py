"""Plain PyTorch optimal-ate pairing: the plain twins of kernels K3-K5.

The counterpart of snark_bn254_verifier_tpu/ops/pairing.py, limited to
what the port's verifiers run:

  * ``miller_product_mixed`` — the product of Miller loops sharing one
    f-squaring chain: at most one variable pair, whose G2 point steps in
    Jacobian coordinates, plus nf pairs with a VK-fixed G2 point, whose
    lines come from host tables (ops/lines.py). The step formulas are the
    JAX package's (pairing.py:44-166, :441-458, :564-582), so the output is
    limb-equal to its ``miller_mixed_hostcall``, not just equal after the
    final exponentiation. Plain twin of kernel K3.
  * ``final_exponentiation`` — f^((p^12-1)/r) by the x-chain
    (pairing.py:324-395 there): easy part, three cyclotomic
    exponentiations by x, then the digit combine. Written as plain Python
    loops over the constant bits. Plain twin of kernel K4.
  * ``miller_loop`` and ``miller_product`` — one full Miller loop per
    (P, Q) pair, both points variable, then the Fq12 product over the pair
    axis (pairing.py:187-234, :406-427 there); the single-proof backend's
    pairings. Plain twin of kernel K5, limb-equal to the JAX package's
    ``miller_product_jit``.
  * ``pairing``, ``pairing_batch`` and ``pairing_batch_is_one`` (pairing.py:
    586-600 there) — whole pairings from the two twins above.
    ops/pairing_cuda.py has the same three over the kernels' wrappers.

All values are (16, C, *batch) limb tensors (see ops/tower.py).
"""

from __future__ import annotations

import torch

from ..oracle import bn254 as bn
from . import field as F
from . import tower as T
from .lines import MILLER_BITS

X_BITS = [int(c) for c in bin(bn.X_PARAM)[2:]]

_I64 = torch.int64


# ---------------------------------------------------------------------------
# Miller-loop steps. T = (X, Y, Z) Jacobian over Fq2; a line is (c0, c1, c3)
# with l(P) = c0*yP + (c1*xP) w + c3 w^3 up to an Fq2 scale.
# ---------------------------------------------------------------------------


def _dbl_step(t):
    x, y, z = t
    a, b, zz, yz = T.fq2_mul_many([(x, x), (y, y), (z, z), (y, z)])
    e = T.fq2_add(T.fq2_double(a), a)  # 3X^2
    xb = T.fq2_add(x, b)
    c, f_, xb2, zzz, ex = T.fq2_mul_many(
        [(b, b), (e, e), (xb, xb), (zz, z), (e, x)]
    )
    d = T.fq2_double(T.fq2_sub(T.fq2_sub(xb2, a), c))
    x3 = T.fq2_sub(f_, T.fq2_double(d))
    z3 = T.fq2_double(yz)
    c8 = T.fq2_double(T.fq2_double(T.fq2_double(c)))
    y3m, c0, c1m, c3m = T.fq2_mul_many([
        (e, T.fq2_sub(d, x3)),
        (z3, zzz),
        (e, zzz),
        (z, T.fq2_sub(ex, T.fq2_double(b))),
    ])
    y3 = T.fq2_sub(y3m, c8)
    return (x3, y3, z3), (c0, T.fq2_neg(c1m), c3m)


def _add_step(t, q):
    x1, y1, z1 = t
    xq, yq = q
    (z1z1,) = T.fq2_mul_many([(z1, z1)])
    u2, s2p = T.fq2_mul_many([(xq, z1z1), (yq, z1z1)])
    (s2,) = T.fq2_mul_many([(s2p, z1)])
    h = T.fq2_sub(u2, x1)
    rr = T.fq2_double(T.fq2_sub(s2, y1))
    hh, rr2 = T.fq2_mul_many([(h, h), (rr, rr)])
    i = T.fq2_double(T.fq2_double(hh))
    z1d = T.fq2_double(z1)
    j, v, z3, rxq, yqz3p = T.fq2_mul_many(
        [(h, i), (x1, i), (z1d, h), (rr, xq), (yq, z1d)]
    )
    x3 = T.fq2_sub(T.fq2_sub(rr2, j), T.fq2_double(v))
    y3a, y3b, yqz3 = T.fq2_mul_many(
        [(rr, T.fq2_sub(v, x3)), (y1, j), (yqz3p, h)]
    )
    y3 = T.fq2_sub(y3a, T.fq2_double(y3b))
    return (x3, y3, z3), (z3, T.fq2_neg(rr), T.fq2_sub(rxq, yqz3))


def _mul_by_line(f, line, xp, yp, skip=None):
    """f * l with l00 = c0*yP, l10 = c1*xP, l11 = c3."""
    c0, c1, c3 = line
    return _mul_by_l(f, T.fq2_mul_fq(c0, yp), T.fq2_mul_fq(c1, xp), c3, skip)


def _mul_by_l(f, l00, l10, l11, skip=None):
    """f * ((l00, 0, 0) + (l10, l11, 0) w); ``skip`` lanes, if given,
    multiply by one (e(O, Q) = e(P, O) = 1)."""
    if skip is not None:
        one = T.fq2_one(l00.shape[2:], l00)
        zero = torch.zeros_like(l00)
        l00 = F.select(skip, one, l00)
        l10 = F.select(skip, zero, l10)
        l11 = F.select(skip, zero, l11)
    f0, f1 = T.fq12_half(f, 0), T.fq12_half(f, 1)
    a0, a1, a2 = T.fq6_c(f1, 0), T.fq6_c(f1, 1), T.fq6_c(f1, 2)
    b0 = T.fq2_add(T.fq6_c(f0, 0), a0)
    b1 = T.fq2_add(T.fq6_c(f0, 1), a1)
    b2 = T.fq2_add(T.fq6_c(f0, 2), a2)
    s0 = T.fq2_add(l00, l10)
    p = T.fq2_mul_many([
        (T.fq6_c(f0, 0), l00), (T.fq6_c(f0, 1), l00), (T.fq6_c(f0, 2), l00),
        (a0, l10), (a2, l11), (a1, l10), (a0, l11), (a2, l10), (a1, l11),
        (b0, s0), (b2, l11), (b1, s0), (b0, l11), (b2, s0), (b1, l11),
    ])
    t0 = T.fq6_from_fq2(p[0], p[1], p[2])
    t1 = T.fq6_from_fq2(
        T.fq2_add(p[3], T.fq2_mul_xi(p[4])),
        T.fq2_add(p[5], p[6]),
        T.fq2_add(p[7], p[8]),
    )
    s = T.fq6_from_fq2(
        T.fq2_add(p[9], T.fq2_mul_xi(p[10])),
        T.fq2_add(p[11], p[12]),
        T.fq2_add(p[13], p[14]),
    )
    c0 = T.fq6_add(t0, T.fq6_mul_by_v(t1))
    c1 = T.fq6_sub(T.fq6_sub(s, t0), t1)
    return T.fq12_from_fq6(c0, c1)


def _fixed_line_apply(f, c1row, c3row, xp, yp, p_inf):
    """f times a precomputed affine line (c0 == 1): l00 = (yP, 0),
    l10 = c1*xP, l11 = c3; rows are (16, 2) table entries."""
    bshape = (1,) * (xp.dim() - 1)
    c1b = c1row.view(c1row.shape + bshape)
    c3b = c3row.view(c3row.shape + bshape)
    l00 = torch.stack([yp, torch.zeros_like(yp)], 1)
    l10 = T.fq2_mul_fq(c1b, xp)
    l11 = c3b.expand(c3b.shape[:2] + xp.shape[1:])
    return _mul_by_l(f, l00, l10, l11, p_inf)


def _g2_frobenius_affine(q, power: int):
    """Untwist-Frobenius pi^power on an affine twist point."""
    xq, yq = q
    gx = bn.fq2_pow(bn.XI, (bn.P**power - 1) // 3)
    gy = bn.fq2_pow(bn.XI, (bn.P**power - 1) // 2)
    if power % 2 == 1:
        xq, yq = T.fq2_conj(xq), T.fq2_conj(yq)
    cx = T.fq2_pack_const(gx, xq).expand(xq.shape)
    cy = T.fq2_pack_const(gy, yq).expand(yq.shape)
    return tuple(T.fq2_mul_many([(xq, cx), (yq, cy)]))


def miller_product_mixed(var_p, var_q, fixed_ps, lines, tails):
    """Product of Miller loops sharing one f-squaring chain.

    var_p, var_q: the variable pair as affine (x, y, inf) tuples — G1
    coords (16, *b), G2 coords (16, 2, *b) — or both None (fixed-only
    product). fixed_ps: tuple of nf affine G1 tuples; lines, tails: the
    nf fixed points' tables (ops/lines.py::tables_from_numpy). Infinity
    pairs contribute one. Where a schedule bit is 0 the add rows are
    skipped, which the JAX package's select discards anyway."""
    nf = len(fixed_ps)
    has_var = var_p is not None
    if nf == 0 and not has_var:
        raise ValueError("empty Miller product")
    if lines.shape[0] != nf or tails.shape[0] != nf:
        raise ValueError("one line table per fixed pair")
    fixed = [(x.to(_I64), y.to(_I64), inf) for x, y, inf in fixed_ps]
    lines, tails = lines.to(_I64), tails.to(_I64)
    like = fixed[0][0] if nf else var_p[0].to(_I64)
    f = T.fq12_one(like.shape[1:], like)
    if has_var:
        xp, yp = var_p[0].to(_I64), var_p[1].to(_I64)
        q = (var_q[0].to(_I64), var_q[1].to(_I64))
        skip_v = var_p[2] | var_q[2]
        t = (q[0], q[1], T.fq2_one(q[0].shape[2:], q[0]))

    def fixed_lines(f, row_c1, row_c3, i):
        for j, (fx, fy, finf) in enumerate(fixed):
            f = _fixed_line_apply(f, lines[j, row_c1, i], lines[j, row_c3, i],
                                  fx, fy, finf)
        return f

    for i, bit in enumerate(MILLER_BITS):
        f = T.fq12_sq(f)
        if has_var:
            t, line = _dbl_step(t)
            f = _mul_by_line(f, line, xp, yp, skip_v)
        f = fixed_lines(f, 0, 1, i)
        if bit:
            if has_var:
                t, line = _add_step(t, q)
                f = _mul_by_line(f, line, xp, yp, skip_v)
            f = fixed_lines(f, 2, 3, i)

    if has_var:
        q1 = _g2_frobenius_affine(q, 1)
        q2x, q2y = _g2_frobenius_affine(q, 2)
        for qq in (q1, (q2x, T.fq2_neg(q2y))):
            t, line = _add_step(t, qq)
            f = _mul_by_line(f, line, xp, yp, skip_v)
    for k in range(2):
        for j, (fx, fy, finf) in enumerate(fixed):
            f = _fixed_line_apply(f, tails[j, 0, k], tails[j, 1, k], fx, fy,
                                  finf)
    return f


def miller_mixed(var_p, var_q, fixed_ps, lines, tails):
    """Plain twin of kernel K3: ``miller_product_mixed`` as (16, 12, *b)
    int32."""
    return miller_product_mixed(var_p, var_q, fixed_ps, lines, tails).to(
        torch.int32
    )


def miller_loop(p_affine, q_affine):
    """f_{6x+2,Q}(P) with the two Frobenius correction lines, per lane.

    p_affine: (x (16, *b), y (16, *b), inf (*b)); q_affine over Fq2
    coordinates (16, 2, *b). Infinity lanes yield one, selected after the
    loop as in the JAX package; where a schedule bit is 0 the add step is
    skipped, which its select discards anyway. Returns (16, 12, *b) int64."""
    xp, yp = p_affine[0].to(_I64), p_affine[1].to(_I64)
    q = (q_affine[0].to(_I64), q_affine[1].to(_I64))
    t = (q[0], q[1], T.fq2_one(q[0].shape[2:], q[0]))
    f = T.fq12_one(xp.shape[1:], xp)
    for bit in MILLER_BITS:
        f = T.fq12_sq(f)
        t, line = _dbl_step(t)
        f = _mul_by_line(f, line, xp, yp)
        if bit:
            t, line = _add_step(t, q)
            f = _mul_by_line(f, line, xp, yp)
    q1 = _g2_frobenius_affine(q, 1)
    q2x, q2y = _g2_frobenius_affine(q, 2)
    for qq in (q1, (q2x, T.fq2_neg(q2y))):
        t, line = _add_step(t, qq)
        f = _mul_by_line(f, line, xp, yp)
    return F.select(p_affine[2] | q_affine[2], T.fq12_one(xp.shape[1:], xp), f)


def miller_product(pairs_p, pairs_q):
    """Plain twin of kernel K5: the product over the pair axis of one Miller
    loop per pair, as (16, 12, *b) int32.

    pairs_p: (x (n,16,*b), y (n,16,*b), inf (n,*b)); pairs_q the same with
    Fq2 coordinates (n,16,2,*b). As in the JAX package, the pair axis is
    folded into the batch, so one loop serves every pair."""
    n = pairs_p[0].shape[0]
    if n < 1:
        raise ValueError("miller_product: needs at least one pair")
    p = (pairs_p[0].movedim(0, 1), pairs_p[1].movedim(0, 1), pairs_p[2])
    q = (pairs_q[0].movedim(0, 2), pairs_q[1].movedim(0, 2), pairs_q[2])
    f = miller_loop(p, q)  # (16, 12, n, *b)
    acc = f[:, :, 0]
    for i in range(1, n):
        acc = T.fq12_mul(acc, f[:, :, i])
    return acc.to(torch.int32)


# ---------------------------------------------------------------------------
# Final exponentiation by the x-chain. With A = m^x, B = m^(x^2),
# C = m^(x^3), the hard part (p^4 - p^2 + 1)/r =
#   p^3 + (6x^2+1) p^2 - (36x^3+18x^2+12x-1) p - (36x^3+30x^2+18x+2).
# ---------------------------------------------------------------------------


def _cyc_exp_x(a):
    """a^x for the BN parameter x, a in the cyclotomic subgroup."""
    acc = a
    for bit in X_BITS[1:]:
        acc = T.fq12_cyclotomic_sq(acc)
        if bit:
            acc = T.fq12_mul(acc, a)
    return acc


def _fe_easy_and_expx(f):
    """f -> (m, A, B, C) = (f^((p^6-1)(p^2+1)), m^x, m^(x^2), m^(x^3))."""
    m = T.fq12_mul(T.fq12_conj(f), T.fq12_inv(f))  # ^(p^6 - 1)
    m = T.fq12_mul(T.fq12_frobenius(m, 2), m)      # ^(p^2 + 1)
    a = _cyc_exp_x(m)
    b = _cyc_exp_x(a)
    return m, a, b, _cyc_exp_x(b)


def _fe_combine(m, a, b, c):
    """t0 = m^-(36x^3+30x^2+18x+2) = conj((C^18 B^15 A^9 m)^2),
    t1 = m^-(36x^3+18x^2+12x-1) = conj((C^18 B^9 A^6)^2) * m,
    t2 = m^(6x^2+1) = (B^3)^2 * m; out = t0 * t1^p * t2^(p^2) * m^(p^3)."""
    mul, sq, conj = T.fq12_mul, T.fq12_cyclotomic_sq, T.fq12_conj

    def ladder(acc, entries):
        for e in entries:
            acc = mul(sq(acc), e)
        return sq(acc)

    ba = mul(b, a)
    acc0 = ladder(c, [ba, b, mul(c, b), mul(ba, m)])
    acc1 = ladder(c, [b, a, mul(c, a), b])
    t0 = conj(acc0)
    t1 = mul(conj(acc1), m)
    t2 = mul(sq(mul(sq(b), b)), m)
    out = mul(t0, T.fq12_frobenius(t1, 1))
    out = mul(out, T.fq12_frobenius(t2, 2))
    return mul(out, T.fq12_frobenius(m, 3))


def final_exponentiation(f):
    """f^((p^12-1)/r) of a (16, 12, *b) tensor (x-chain)."""
    return _fe_combine(*_fe_easy_and_expx(f.to(_I64)))


def final_exp(f):
    """Plain twin of kernel K4: (16, 12, *b) int32 -> int32."""
    return final_exponentiation(f).to(torch.int32)


# ---------------------------------------------------------------------------
# Whole pairings
# ---------------------------------------------------------------------------


def pairing(p_affine, q_affine):
    """e(P, Q) per lane: P (x (16,*b), y, inf (*b)), Q with Fq2 coordinates
    (16,2,*b); (16, 12, *b) int32."""
    return pairing_batch(tuple(t.unsqueeze(0) for t in p_affine),
                         tuple(t.unsqueeze(0) for t in q_affine))


def pairing_batch(pairs_p, pairs_q):
    """The product of n pairings per lane, one shared final exponentiation:
    pair-major P (x (n,16,*b), y, inf (n,*b)) and Q (n,16,2,*b) coordinates
    -> (16, 12, *b) int32."""
    return final_exp(miller_product(pairs_p, pairs_q))


def pairing_batch_is_one(pairs_p, pairs_q):
    """(*b) bool: the product of the pairings is one."""
    gt = pairing_batch(pairs_p, pairs_q)
    return T.fq12_eq(gt, T.fq12_one(gt.shape[2:], gt))

"""Plain PyTorch BN254 tower: Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3-XI),
Fq12 = Fq6[w]/(w^2-v), XI = 9+u.

The counterpart of snark_bn254_verifier_tpu/ops/tower.py, in its layout: a
degree-C element is one ``(16, C, *batch)`` tensor, components

    Fq2 : [re, im]
    Fq6 : [v0.re, v0.im, v1.re, v1.im, v2.re, v2.im]
    Fq12: [c0 (Fq6) | c1 (Fq6)]   (component 6h + 2j + c)

As in the JAX package, the independent Montgomery products of each level
are stacked into one wide ``mont_mul`` call (``fq2_mul_many``), so an Fq12
multiply is a handful of torch calls. Constants (XI powers, Frobenius
gammas) come from the oracle.
"""

from __future__ import annotations

import functools

import torch

from snark_bn254_verifier_tpu.oracle import bn254 as bn

from . import field as F
from .limbs import FQ


@functools.lru_cache(maxsize=None)
def _packed_const(coeffs: tuple, device: torch.device) -> torch.Tensor:
    arr = torch.stack([torch.as_tensor(FQ.pack_scalar(c)) for c in coeffs], 1)
    return arr.to(dtype=torch.int64, device=device)


def pack_const(coeffs, like):
    """Tuple of C Fq ints -> (16, C, 1, ...) Montgomery constant."""
    c = _packed_const(tuple(coeffs), like.device).to(like.dtype)
    return c.view(c.shape + (1,) * (like.dim() - 2))


def fq2_pack_const(val, like):
    return pack_const((val[0], val[1]), like)


def fq2_mul_many(pairs, mul=F.fq_mul):
    """Karatsuba Fq2 products of every (a, b) pair in one Montgomery call
    of width 3k. ``mul`` is the Fq product to use (the plain one, or the
    K1 wrapper on the main path's G2 mask)."""
    k = len(pairs)
    a = torch.stack([p[0] for p in pairs], 1)  # (16, k, 2, *b)
    b = torch.stack([p[1] for p in pairs], 1)
    sa = F.fq_add(a[:, :, 0], a[:, :, 1])
    sb = F.fq_add(b[:, :, 0], b[:, :, 1])
    t = mul(torch.cat([a[:, :, 0], a[:, :, 1], sa], 1),
            torch.cat([b[:, :, 0], b[:, :, 1], sb], 1))
    t0, t1, t2 = t[:, :k], t[:, k:2 * k], t[:, 2 * k:]
    c0 = F.fq_sub(t0, t1)
    c1 = F.fq_sub(t2, F.fq_add(t0, t1))
    out = torch.stack([c0, c1], 2)  # (16, k, 2, *b)
    return [out[:, i] for i in range(k)]


# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------


def fq2_add(a, b):
    return F.fq_add(a, b)


def fq2_sub(a, b):
    return F.fq_sub(a, b)


def fq2_neg(a):
    return F.fq_neg(a)


def fq2_double(a):
    return F.fq_add(a, a)


def fq2_conj(a):
    return torch.stack([a[:, 0], F.fq_neg(a[:, 1])], 1)


def fq2_mul(a, b):
    return fq2_mul_many([(a, b)])[0]


def fq2_sq(a):
    return fq2_mul(a, a)


def fq2_mul_fq(a, s):
    """Both components times an Fq element s of shape (16, *b)."""
    return F.fq_mul(a, s.unsqueeze(1))


def _mul9(x):
    x2 = F.fq_add(x, x)
    x4 = F.fq_add(x2, x2)
    x8 = F.fq_add(x4, x4)
    return F.fq_add(x8, x)


def fq2_mul_xi(a):
    """Times XI = 9 + u: (9a0 - a1) + (a0 + 9a1)u."""
    a9 = _mul9(a)
    return torch.stack(
        [F.fq_sub(a9[:, 0], a[:, 1]), F.fq_add(a[:, 0], a9[:, 1])], 1
    )


def fq2_inv(a):
    n = F.fq_add(F.fq_sq(a[:, 0]), F.fq_sq(a[:, 1]))
    ninv = F.fq_inv(n)
    return torch.stack(
        [F.fq_mul(a[:, 0], ninv), F.fq_neg(F.fq_mul(a[:, 1], ninv))], 1
    )


def fq2_is_zero(a):
    return (a == 0).all(dim=0).all(dim=0)


def fq2_eq(a, b):
    return (a == b).all(dim=0).all(dim=0)


def fq2_one(batch_shape, like):
    out = torch.zeros((16, 2) + tuple(batch_shape), dtype=like.dtype,
                      device=like.device)
    out[:, 0] = F.one_mont(FQ, out[:, 0])
    return out


# ---------------------------------------------------------------------------
# Fq6 — (16, 6, *b); component 2 * v_power + imag
# ---------------------------------------------------------------------------


def fq6_c(a, i):
    return a[:, 2 * i:2 * i + 2]


def fq6_from_fq2(c0, c1, c2):
    return torch.cat([c0, c1, c2], 1)


def fq6_add(a, b):
    return F.fq_add(a, b)


def fq6_sub(a, b):
    return F.fq_sub(a, b)


def fq6_neg(a):
    return F.fq_neg(a)


def _fq6_mul_pairs(pairs):
    """Toom-style Fq6 products: 6 Fq2 products per pair, all in one call."""
    mul_pairs = []
    for x, y in pairs:
        x0, x1, x2 = fq6_c(x, 0), fq6_c(x, 1), fq6_c(x, 2)
        y0, y1, y2 = fq6_c(y, 0), fq6_c(y, 1), fq6_c(y, 2)
        mul_pairs += [
            (x0, y0),
            (x1, y1),
            (x2, y2),
            (fq2_add(x1, x2), fq2_add(y1, y2)),
            (fq2_add(x0, x1), fq2_add(y0, y1)),
            (fq2_add(x0, x2), fq2_add(y0, y2)),
        ]
    prods = fq2_mul_many(mul_pairs)
    outs = []
    for i in range(len(pairs)):
        t0, t1, t2, m12, m01, m02 = prods[6 * i:6 * i + 6]
        c0 = fq2_add(t0, fq2_mul_xi(fq2_sub(m12, fq2_add(t1, t2))))
        c1 = fq2_add(fq2_sub(m01, fq2_add(t0, t1)), fq2_mul_xi(t2))
        c2 = fq2_add(fq2_sub(m02, fq2_add(t0, t2)), t1)
        outs.append(fq6_from_fq2(c0, c1, c2))
    return outs


def fq6_mul(a, b):
    return _fq6_mul_pairs([(a, b)])[0]


def fq6_mul_by_v(a):
    return fq6_from_fq2(fq2_mul_xi(fq6_c(a, 2)), fq6_c(a, 0), fq6_c(a, 1))


def fq6_inv(a):
    a0, a1, a2 = fq6_c(a, 0), fq6_c(a, 1), fq6_c(a, 2)
    s0, s1, s2, m12, m01, m02 = fq2_mul_many(
        [(a0, a0), (a1, a1), (a2, a2), (a1, a2), (a0, a1), (a0, a2)]
    )
    c0 = fq2_sub(s0, fq2_mul_xi(m12))
    c1 = fq2_sub(fq2_mul_xi(s2), m01)
    c2 = fq2_sub(s1, m02)
    p0, p1, p2 = fq2_mul_many([(a2, c1), (a1, c2), (a0, c0)])
    t = fq2_add(fq2_mul_xi(fq2_add(p0, p1)), p2)
    tinv = fq2_inv(t)
    return fq6_from_fq2(*fq2_mul_many([(c0, tinv), (c1, tinv), (c2, tinv)]))


# ---------------------------------------------------------------------------
# Fq12 — (16, 12, *b) = [c0 | c1] over Fq6
# ---------------------------------------------------------------------------


def fq12_half(a, i):
    return a[:, 6 * i:6 * i + 6]


def fq12_from_fq6(c0, c1):
    return torch.cat([c0, c1], 1)


def fq12_mul(a, b):
    a0, a1 = fq12_half(a, 0), fq12_half(a, 1)
    b0, b1 = fq12_half(b, 0), fq12_half(b, 1)
    t0, t1, t2 = _fq6_mul_pairs(
        [(a0, b0), (a1, b1), (fq6_add(a0, a1), fq6_add(b0, b1))]
    )
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(t2, fq6_add(t0, t1))
    return fq12_from_fq6(c0, c1)


def fq12_sq(a):
    """Complex squaring: t = a0*a1; s = (a0+a1)(a0+v*a1)."""
    a0, a1 = fq12_half(a, 0), fq12_half(a, 1)
    t, s = _fq6_mul_pairs(
        [(a0, a1), (fq6_add(a0, a1), fq6_add(a0, fq6_mul_by_v(a1)))]
    )
    c0 = fq6_sub(fq6_sub(s, t), fq6_mul_by_v(t))
    return fq12_from_fq6(c0, fq6_add(t, t))


def fq12_conj(a):
    return fq12_from_fq6(fq12_half(a, 0), fq6_neg(fq12_half(a, 1)))


def fq12_inv(a):
    a0, a1 = fq12_half(a, 0), fq12_half(a, 1)
    s0, s1 = _fq6_mul_pairs([(a0, a0), (a1, a1)])
    tinv = fq6_inv(fq6_sub(s0, fq6_mul_by_v(s1)))
    o0, o1 = _fq6_mul_pairs([(a0, tinv), (a1, tinv)])
    return fq12_from_fq6(o0, fq6_neg(o1))


def fq12_one(batch_shape, like):
    out = torch.zeros((16, 12) + tuple(batch_shape), dtype=like.dtype,
                      device=like.device)
    out[:, 0] = F.one_mont(FQ, out[:, 0])
    return out


def fq12_eq(a, b):
    return (a == b).all(dim=0).all(dim=0)


# --- Frobenius -------------------------------------------------------------

# w-basis coefficient i of an Fq12 element sits at tower slot (h, j), i.e.
# components 6h + 2j and 6h + 2j + 1.
_WB_ORDER = [(0, 0), (1, 0), (0, 1), (1, 1), (0, 2), (1, 2)]


def frob_gammas(power: int):
    """gamma_i = XI^(i (p^power - 1) / 6), i = 0..5."""
    return [bn.fq2_pow(bn.XI, i * (bn.P**power - 1) // 6) for i in range(6)]


def fq12_frobenius(a, power: int = 1):
    if power not in (1, 2, 3):
        raise ValueError("Frobenius power must be 1, 2 or 3")
    coeffs = []
    for h, j in _WB_ORDER:
        c = a[:, 6 * h + 2 * j:6 * h + 2 * j + 2]
        coeffs.append(fq2_conj(c) if power % 2 else c)
    prods = fq2_mul_many(
        [(c, fq2_pack_const(g, c).expand(c.shape))
         for c, g in zip(coeffs, frob_gammas(power))]
    )
    slot_to_wb = {6 * h + 2 * j: i for i, (h, j) in enumerate(_WB_ORDER)}
    return torch.cat([prods[slot_to_wb[s]] for s in range(0, 12, 2)], 1)


# --- cyclotomic squaring ---------------------------------------------------


def fq12_cyclotomic_sq(a):
    """Granger-Scott squaring in the cyclotomic subgroup: 9 Fq2 products."""
    z0 = fq6_c(fq12_half(a, 0), 0)
    z4 = fq6_c(fq12_half(a, 0), 1)
    z3 = fq6_c(fq12_half(a, 0), 2)
    z2 = fq6_c(fq12_half(a, 1), 0)
    z1 = fq6_c(fq12_half(a, 1), 1)
    z5 = fq6_c(fq12_half(a, 1), 2)
    pairs = []
    for x, y in ((z0, z1), (z2, z3), (z4, z5)):
        s = fq2_add(x, y)
        pairs += [(x, x), (y, y), (s, s)]
    prods = fq2_mul_many(pairs)

    def fp4(idx):
        t0, t1, t2 = prods[3 * idx:3 * idx + 3]
        return fq2_add(fq2_mul_xi(t1), t0), fq2_sub(fq2_sub(t2, t0), t1)

    a0, a1 = fp4(0)
    b0, b1 = fp4(1)
    c0, c1 = fp4(2)

    def m3(x):
        return fq2_add(fq2_add(x, x), x)

    def m2(x):
        return fq2_add(x, x)

    z0n = fq2_sub(m3(a0), m2(z0))
    z1n = fq2_add(m3(a1), m2(z1))
    z4n = fq2_sub(m3(b0), m2(z4))
    z5n = fq2_add(m3(b1), m2(z5))
    z2n = fq2_add(m3(fq2_mul_xi(c1)), m2(z2))
    z3n = fq2_sub(m3(c0), m2(z3))
    return fq12_from_fq6(
        fq6_from_fq2(z0n, z4n, z3n), fq6_from_fq2(z2n, z1n, z5n)
    )

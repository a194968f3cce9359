"""k * G for the generators of G1 and G2 by fixed-base windows.

Every point the proof generator writes is a known multiple of a
generator (the trapdoor), so one table a group serves every proof: 32
windows of 8 bits, each with its 255 multiples in affine form (built once,
one batched inversion), and a product is 32 mixed additions in Jacobian
coordinates, then one inversion: about 0.3 ms a G1 product and 0.9 ms a
G2 product in CPython, where affine double-and-add takes 80 ms.
"""

from __future__ import annotations

import functools

from ..reference import bn254 as bn

P, R = bn.P, bn.R
WINDOW = 8
N_WINDOWS = 32


class _Field:
    """Fq or Fq2 operations on plain ints or (c0, c1) tuples."""

    def __init__(self, add, sub, mul, sq, inv, zero, one):
        self.add, self.sub, self.mul, self.sq, self.inv = add, sub, mul, sq, inv
        self.zero, self.one = zero, one


FQ = _Field(lambda a, b: (a + b) % P, lambda a, b: (a - b) % P, lambda a, b: a * b % P,
            lambda a: a * a % P, lambda a: pow(a, -1, P), 0, 1)
FQ2 = _Field(bn.fq2_add, bn.fq2_sub, bn.fq2_mul, bn.fq2_sq, bn.fq2_inv, bn.FQ2_ZERO,
             bn.FQ2_ONE)


def _double(f: _Field, pt):
    if pt is None:
        return None
    x, y, z = pt
    if y == f.zero:
        return None
    a, b = f.sq(x), f.sq(y)
    c = f.sq(b)
    d = f.sub(f.sq(f.add(x, b)), f.add(a, c))
    d = f.add(d, d)
    e = f.add(f.add(a, a), a)
    x3 = f.sub(f.sq(e), f.add(d, d))
    c8 = f.add(c, c)
    c8 = f.add(c8, c8)
    c8 = f.add(c8, c8)
    yz = f.mul(y, z)
    return (x3, f.sub(f.mul(e, f.sub(d, x3)), c8), f.add(yz, yz))


def _add_mixed(f: _Field, pt, q):
    """Jacobian pt plus affine q."""
    if pt is None:
        return (q[0], q[1], f.one)
    x1, y1, z1 = pt
    z1z1 = f.sq(z1)
    u2 = f.mul(q[0], z1z1)
    s2 = f.mul(q[1], f.mul(z1, z1z1))
    if u2 == x1:
        return _double(f, pt) if s2 == y1 else None
    h = f.sub(u2, x1)
    hh = f.sq(h)
    i = f.add(hh, hh)
    i = f.add(i, i)
    j = f.mul(h, i)
    r = f.sub(s2, y1)
    r = f.add(r, r)
    v = f.mul(x1, i)
    x3 = f.sub(f.sub(f.sq(r), j), f.add(v, v))
    y1j = f.mul(y1, j)
    y3 = f.sub(f.mul(r, f.sub(v, x3)), f.add(y1j, y1j))
    z3 = f.sub(f.sub(f.sq(f.add(z1, h)), z1z1), hh)
    return (x3, y3, z3)


def _affine_all(f: _Field, pts):
    """Jacobian points (none at infinity) to affine, one inversion in all."""
    prefix, acc = [], f.one
    for _, _, z in pts:
        prefix.append(acc)
        acc = f.mul(acc, z)
    inv = f.inv(acc)
    out = [None] * len(pts)
    for i in range(len(pts) - 1, -1, -1):
        x, y, z = pts[i]
        zi = f.mul(inv, prefix[i])
        inv = f.mul(inv, z)
        zi2 = f.sq(zi)
        out[i] = (f.mul(x, zi2), f.mul(y, f.mul(zi2, zi)))
    return out


class FixedBase:
    """k * gen for any k, by the 8-bit windows of k."""

    def __init__(self, f: _Field, gen):
        self.f = f
        rows, base = [], gen
        for _ in range(N_WINDOWS):
            row = [(base[0], base[1], f.one)]
            for _ in range((1 << WINDOW) - 2):
                row.append(_add_mixed(f, row[-1], base))
            rows.append(row)
            nxt = row[0]
            for _ in range(WINDOW):
                nxt = _double(f, nxt)
            base = _affine_all(f, [nxt])[0]
        flat = _affine_all(f, [p for row in rows for p in row])
        n = (1 << WINDOW) - 1
        self.table = [[None] + flat[i * n:(i + 1) * n] for i in range(N_WINDOWS)]

    def mul(self, k: int):
        k %= R
        acc = None
        for row in self.table:
            d = k & 0xFF
            if d:
                acc = _add_mixed(self.f, acc, row[d])
            k >>= WINDOW
        return None if acc is None else _affine_all(self.f, [acc])[0]


@functools.lru_cache(maxsize=None)
def tables():
    """(G1's table, G2's table), built on first use (about a second)."""
    return FixedBase(FQ, bn.G1_GEN), FixedBase(FQ2, bn.G2_GEN)

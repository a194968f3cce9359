"""Pure-Python BN254 (alt_bn128) arithmetic: fields, tower, curves, pairing.

The benchmark's frozen copy of the port's oracle (plain Python integers,
every constant derived numerically here), kept under the benchmark's own
directory so that the reference verifiers and the proof generator depend
on nothing of the program under test. One change: an Fq inverse is
Python's extended-Euclid ``pow(a, -1, P)`` (about 2 us) instead of
Fermat's ``pow(a, P - 2, P)`` (about 200 us); the results are equal.

Semantics follow the behavior of the reference verifier's math backend
(`substrate-bn`, consumed by the reference's verifier crate — see e.g.
verifier/src/groth16/verify.rs:2, verifier/src/plonk/kzg.rs:2). This is a
from-scratch implementation; only the mathematical behavior matches.

Conventions
-----------
* Fq / Fr elements: plain ints in [0, modulus).
* Fq2: tuple (c0, c1) meaning c0 + c1*u with u^2 = -1.
* Fq6: tuple of 3 Fq2 meaning a0 + a1*v + a2*v^2 with v^3 = XI = 9 + u.
* Fq12: tuple of 2 Fq6 meaning c0 + c1*w with w^2 = v.
* G1 points: affine tuples (x, y), infinity = None.
* G2 points: affine tuples of Fq2, infinity = None.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Moduli (BN254 / alt_bn128). These two integers are the only externally
# specified constants besides the curve parameter X and the generators.
# ---------------------------------------------------------------------------

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BN parameter: p = 36x^4 + 36x^3 + 24x^2 + 6x + 1, r = 36x^4 + 36x^3 + 18x^2 + 6x + 1
X_PARAM = 4965661367192848881
ATE_LOOP_COUNT = 6 * X_PARAM + 2  # 29793968203157093288

assert P == 36 * X_PARAM**4 + 36 * X_PARAM**3 + 24 * X_PARAM**2 + 6 * X_PARAM + 1
assert R == 36 * X_PARAM**4 + 36 * X_PARAM**3 + 18 * X_PARAM**2 + 6 * X_PARAM + 1

B_G1 = 3  # E/Fq: y^2 = x^3 + 3

# ---------------------------------------------------------------------------
# Fq arithmetic
# ---------------------------------------------------------------------------


def fq_add(a, b):
    return (a + b) % P


def fq_sub(a, b):
    return (a - b) % P


def fq_mul(a, b):
    return (a * b) % P


def fq_neg(a):
    return (-a) % P


def fq_inv(a):
    if a == 0:
        raise ZeroDivisionError("Fq inverse of zero")
    return pow(a, -1, P)


def fq_sqrt(a):
    """Square root in Fq (p % 4 == 3). Returns None if a is a non-residue."""
    if a == 0:
        return 0
    y = pow(a, (P + 1) // 4, P)
    if y * y % P != a:
        return None
    return y


# ---------------------------------------------------------------------------
# Fq2 = Fq[u] / (u^2 + 1)
# ---------------------------------------------------------------------------

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)
XI = (9, 1)  # sextic non-residue used for the Fq6/Fq12 tower and the twist


def fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fq2_conj(a):
    return (a[0], (-a[1]) % P)


def fq2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    # (a0+a1 u)(b0+b1 u) = a0b0 - a1b1 + (a0b1 + a1b0) u
    return ((t0 - t1) % P, (a0 * b1 + a1 * b0) % P)


def fq2_mul_scalar(a, s):
    return (a[0] * s % P, a[1] * s % P)


def fq2_sq(a):
    a0, a1 = a
    # (a0 + a1 u)^2 = a0^2 - a1^2 + 2 a0 a1 u
    return ((a0 - a1) * (a0 + a1) % P, 2 * a0 * a1 % P)


def fq2_inv(a):
    a0, a1 = a
    norm = (a0 * a0 + a1 * a1) % P
    ninv = fq_inv(norm)
    return (a0 * ninv % P, (-a1) * ninv % P)


def fq2_pow(a, e):
    result = FQ2_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fq2_mul(result, base)
        base = fq2_sq(base)
        e >>= 1
    return result


def fq2_is_zero(a):
    return a[0] == 0 and a[1] == 0


def fq2_sqrt(a):
    """Square root in Fq2 via the complex-method for p % 4 == 3.

    Returns some y with y^2 == a, or None if a is a non-residue.
    """
    if fq2_is_zero(a):
        return FQ2_ZERO
    # Algorithm 9 (Adj, Rodriguez-Henriquez) specialised to p % 4 == 3:
    a1 = fq2_pow(a, (P - 3) // 4)
    alpha = fq2_mul(fq2_sq(a1), a)
    x0 = fq2_mul(a1, a)
    if alpha == (P - 1, 0):
        # y = u * x0
        y = (fq_neg(x0[1]), x0[0])
    else:
        b = fq2_pow(fq2_add(FQ2_ONE, alpha), (P - 1) // 2)
        y = fq2_mul(b, x0)
    if fq2_sq(y) != a:
        return None
    return y


def fq2_lexicographically_largest(a):
    """gnark's ordering on Fq2: decide by c1 (imaginary) first, then c0.

    An Fq element z is "lexicographically largest" iff z > (p-1)/2.
    """
    half = (P - 1) // 2
    if a[1] != 0:
        return a[1] > half
    return a[0] > half


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v] / (v^3 - XI)
# ---------------------------------------------------------------------------

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_add(a, b):
    return (fq2_add(a[0], b[0]), fq2_add(a[1], b[1]), fq2_add(a[2], b[2]))


def fq6_sub(a, b):
    return (fq2_sub(a[0], b[0]), fq2_sub(a[1], b[1]), fq2_sub(a[2], b[2]))


def fq6_neg(a):
    return (fq2_neg(a[0]), fq2_neg(a[1]), fq2_neg(a[2]))


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    # Karatsuba-like (Toom) interpolation
    c0 = fq2_add(t0, fq2_mul(XI, fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(t1, t2))))
    c1 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)), fq2_mul(XI, t2))
    c2 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fq6_sq(a):
    return fq6_mul(a, a)


def fq6_mul_by_v(a):
    # (a0 + a1 v + a2 v^2) * v = XI*a2 + a0 v + a1 v^2
    return (fq2_mul(XI, a[2]), a[0], a[1])


def fq6_mul_fq2(a, s):
    return (fq2_mul(a[0], s), fq2_mul(a[1], s), fq2_mul(a[2], s))


def fq6_inv(a):
    a0, a1, a2 = a
    # Standard formula via the resultant
    c0 = fq2_sub(fq2_sq(a0), fq2_mul(XI, fq2_mul(a1, a2)))
    c1 = fq2_sub(fq2_mul(XI, fq2_sq(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_sq(a1), fq2_mul(a0, a2))
    t = fq2_add(
        fq2_mul(XI, fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2))),
        fq2_mul(a0, c0),
    )
    tinv = fq2_inv(t)
    return (fq2_mul(c0, tinv), fq2_mul(c1, tinv), fq2_mul(c2, tinv))


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w] / (w^2 - v)
# ---------------------------------------------------------------------------

FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), fq6_add(t0, t1))
    return (c0, c1)


def fq12_sq(a):
    return fq12_mul(a, a)


def fq12_conj(a):
    """Conjugation = Frobenius^6: c0 - c1 w."""
    return (a[0], fq6_neg(a[1]))


def fq12_inv(a):
    a0, a1 = a
    t = fq6_sub(fq6_sq(a0), fq6_mul_by_v(fq6_sq(a1)))
    tinv = fq6_inv(t)
    return (fq6_mul(a0, tinv), fq6_neg(fq6_mul(a1, tinv)))


def fq12_pow(a, e):
    result = FQ12_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sq(base)
        e >>= 1
    return result


def fq12_is_one(a):
    return a == FQ12_ONE


# --- w-basis view: Fq12 element as sum_{i=0}^{5} a_i w^i with a_i in Fq2 ----


def fq12_to_wbasis(a):
    (b0, b1, b2), (d0, d1, d2) = a
    return [b0, d0, b1, d1, b2, d2]


def fq12_from_wbasis(coeffs):
    b0, d0, b1, d1, b2, d2 = coeffs
    return ((b0, b1, b2), (d0, d1, d2))


# Frobenius coefficients, derived numerically: gamma = XI^((p-1)/6) in Fq2.
# frob(sum a_i w^i) = sum conj(a_i) * gamma^i * w^i
_GAMMA_1 = fq2_pow(XI, (P - 1) // 6)
FROB_GAMMA1 = [fq2_pow(_GAMMA_1, i) for i in range(6)]


def fq12_frobenius(a):
    coeffs = fq12_to_wbasis(a)
    out = [fq2_mul(fq2_conj(c), FROB_GAMMA1[i]) for i, c in enumerate(coeffs)]
    return fq12_from_wbasis(out)


def fq12_frobenius_n(a, n):
    for _ in range(n):
        a = fq12_frobenius(a)
    return a


# ---------------------------------------------------------------------------
# G1: E/Fq : y^2 = x^3 + 3
# ---------------------------------------------------------------------------

G1_GEN = (1, 2)


def g1_is_on_curve(pt):
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + B_G1)) % P == 0


def g1_neg(pt):
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % P)


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        # doubling
        lam = 3 * x1 * x1 * fq_inv(2 * y1 % P) % P
    else:
        lam = (y2 - y1) * fq_inv((x2 - x1) % P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_double(pt):
    return g1_add(pt, pt)


def g1_jac_double(pt):
    """2 * (X, Y, Z) in Jacobian coordinates (x = X / Z^2, y = Y / Z^3);
    None is infinity."""
    if pt is None:
        return None
    x, y, z = pt
    if y == 0:
        return None
    a, b = x * x % P, y * y % P
    c = b * b % P
    d = 2 * ((x + b) ** 2 - a - c) % P
    e = 3 * a % P
    x3 = (e * e - 2 * d) % P
    return (x3, (e * (d - x3) - 8 * c) % P, 2 * y * z % P)


def g1_jac_add(p1, p2):
    """p1 + p2, both Jacobian (None is infinity)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1, z2z2 = z1 * z1 % P, z2 * z2 % P
    u1, u2 = x1 * z2z2 % P, x2 * z1z1 % P
    s1, s2 = y1 * z2 * z2z2 % P, y2 * z1 * z1z1 % P
    if u1 == u2:
        return g1_jac_double(p1) if s1 == s2 else None
    h = (u2 - u1) % P
    i = 4 * h * h % P
    j = h * i % P
    r = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (r * r - j - 2 * v) % P
    return (x3, (r * (v - x3) - 2 * s1 * j) % P, ((z1 + z2) ** 2 - z1z1 - z2z2) * h % P)


def g1_to_jac(pt):
    return None if pt is None else (pt[0], pt[1], 1)


def g1_from_jac(pt):
    if pt is None:
        return None
    x, y, z = pt
    zi = pow(z, -1, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


def g1_mul(pt, k):
    return g1_msm([pt], [k])


def g1_msm(points, scalars):
    """sum k_i P_i by Straus with 4-bit windows: one shared chain of
    doublings, a table of 15 multiples a point."""
    tables = []
    for pt in points:
        row = [None, g1_to_jac(pt)]
        for _ in range(14):
            row.append(g1_jac_add(row[-1], row[1]))
        tables.append(row)
    ks = [k % R for k in scalars]
    acc = None
    for shift in range(252, -1, -4):
        for _ in range(4):
            acc = g1_jac_double(acc)
        for row, k in zip(tables, ks):
            d = (k >> shift) & 15
            if d:
                acc = g1_jac_add(acc, row[d])
    return g1_from_jac(acc)


# ---------------------------------------------------------------------------
# G2: E'/Fq2 : y^2 = x^3 + 3/XI (D-type sextic twist)
# ---------------------------------------------------------------------------

B_G2 = fq2_mul_scalar(fq2_inv(XI), B_G1)  # 3 / (9 + u)

# Standard generator of the r-torsion subgroup on the twist (alt_bn128 /
# EIP-197 convention; validated in tests by on-curve and order checks).
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


def g2_is_on_curve(pt):
    if pt is None:
        return True
    x, y = pt
    lhs = fq2_sq(y)
    rhs = fq2_add(fq2_mul(fq2_sq(x), x), B_G2)
    return lhs == rhs


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], fq2_neg(pt[1]))


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if fq2_is_zero(fq2_add(y1, y2)):
            return None
        lam = fq2_mul(
            fq2_mul_scalar(fq2_sq(x1), 3),
            fq2_inv(fq2_mul_scalar(y1, 2)),
        )
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_sq(lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(pt, k):
    k = k % R
    result = None
    addend = pt
    while k:
        if k & 1:
            result = g2_add(result, addend)
        addend = g2_add(addend, addend)
        k >>= 1
    return result


# Untwist-Frobenius endomorphism coefficients (derived numerically):
# pi(x, y) = (conj(x) * XI^((p-1)/3), conj(y) * XI^((p-1)/2))
FROB_TWIST_X = fq2_pow(XI, (P - 1) // 3)
FROB_TWIST_Y = fq2_pow(XI, (P - 1) // 2)


def g2_frobenius(pt):
    if pt is None:
        return None
    x, y = pt
    return (fq2_mul(fq2_conj(x), FROB_TWIST_X), fq2_mul(fq2_conj(y), FROB_TWIST_Y))


# ---------------------------------------------------------------------------
# Optimal ate pairing
# ---------------------------------------------------------------------------


def _line(t, q, p):
    """Line through twist points t and q (t == q for tangent), evaluated at
    the G1 point p, as a sparse Fq12 element; also returns t + q.

    For the D-type twist the line evaluated at P = (xP, yP) is
        l(P) = yP - lambda*xP * w + (lambda*x_t - y_t) * w^3
    with all coefficients embedded via the w-basis (w^2 = v, w^6 = XI).
    """
    xt, yt = t
    if t == q:
        lam = fq2_mul(fq2_mul_scalar(fq2_sq(xt), 3), fq2_inv(fq2_mul_scalar(yt, 2)))
    else:
        xq, yq = q
        if xt == xq:
            # vertical line: l(P) = xP - x_t * w^2
            coeffs = [
                (p[0] % P, 0),
                FQ2_ZERO,
                fq2_neg(xt),
                FQ2_ZERO,
                FQ2_ZERO,
                FQ2_ZERO,
            ]
            return fq12_from_wbasis(coeffs), g2_add(t, q)
        lam = fq2_mul(fq2_sub(yq, yt), fq2_inv(fq2_sub(xq, xt)))
    c0 = (p[1] % P, 0)
    c1 = fq2_mul_scalar(fq2_neg(lam), p[0])
    c3 = fq2_sub(fq2_mul(lam, xt), yt)
    coeffs = [c0, c1, FQ2_ZERO, c3, FQ2_ZERO, FQ2_ZERO]
    return fq12_from_wbasis(coeffs), g2_add(t, q)


def miller_loop(p, q):
    """Miller loop of the optimal ate pairing, f_{6x+2, Q}(P) with the two
    Frobenius correction lines. Inputs are affine G1/G2 (twist) points."""
    if p is None or q is None:
        return FQ12_ONE
    t = q
    f = FQ12_ONE
    bits = bin(ATE_LOOP_COUNT)[2:]
    for bit in bits[1:]:
        lf, t = _line(t, t, p)
        f = fq12_mul(fq12_sq(f), lf)
        if bit == "1":
            lf, t = _line(t, q, p)
            f = fq12_mul(f, lf)
    q1 = g2_frobenius(q)
    q2 = g2_neg(g2_frobenius(g2_frobenius(q)))
    lf, t = _line(t, q1, p)
    f = fq12_mul(f, lf)
    lf, t = _line(t, q2, p)
    f = fq12_mul(f, lf)
    return f


# Final exponentiation: f^((p^12 - 1) / r).
# Easy part: f^((p^6 - 1)(p^2 + 1)); hard part exponent decomposed in base p
# so it can be evaluated with Frobenius maps + a 4-way Straus multi-exp.
HARD_PART_EXP = (P**4 - P**2 + 1) // R
HARD_DIGITS = []  # base-p digits, little-endian: d = sum HARD_DIGITS[i] p^i
_d = HARD_PART_EXP
while _d:
    HARD_DIGITS.append(_d % P)
    _d //= P
assert len(HARD_DIGITS) == 4


def final_exponentiation(f):
    # Easy part
    f1 = fq12_conj(f)
    f2 = fq12_inv(f)
    f = fq12_mul(f1, f2)              # f^(p^6 - 1)
    f = fq12_mul(fq12_frobenius_n(f, 2), f)  # ^(p^2 + 1)
    # Hard part: f^d with d = sum digits[i] * p^i
    bases = [fq12_frobenius_n(f, i) for i in range(len(HARD_DIGITS))]
    result = FQ12_ONE
    nbits = max(d.bit_length() for d in HARD_DIGITS)
    for bit in range(nbits - 1, -1, -1):
        result = fq12_sq(result)
        for base, digit in zip(bases, HARD_DIGITS):
            if (digit >> bit) & 1:
                result = fq12_mul(result, base)
    return result


def pairing(p, q):
    """Full optimal ate pairing e(P, Q) -> Fq12 (Gt)."""
    return final_exponentiation(miller_loop(p, q))


def pairing_batch(pairs):
    """Product of pairings with a single shared final exponentiation —
    the semantics of bn::pairing_batch (reference call sites:
    verifier/src/groth16/verify.rs:73, verifier/src/plonk/kzg.rs:180)."""
    f = FQ12_ONE
    for p, q in pairs:
        f = fq12_mul(f, miller_loop(p, q))
    return final_exponentiation(f)

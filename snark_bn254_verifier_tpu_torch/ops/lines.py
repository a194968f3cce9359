"""Precomputed Miller-loop line tables for VK-fixed G2 points, JAX-free.

The counterpart of snark_bn254_verifier_tpu/ops/lines.py (which imports
JAX through its field module for one constant): the same walk of the
optimal-ate schedule (lines.py:93-135 there) on the oracle's exact
integers, emitting every line's affine-normalised (c1, c3) with c0 == 1:

    l(P) = yP - lambda*xP * w + (lambda*x_t - y_t) * w^3

The tables are batch independent, about 34 KB per fixed point, and are
computed once per VK on the host. ``tables_from_numpy`` turns tables of
either package into the port's tensors, so the tests can feed both
packages the same state.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..oracle import bn254 as bn
from .limbs import FQ

# Bits of 6x+2 after the leading one: STEPS doubling steps, with an add
# step where the bit is set, then the two Frobenius correction adds.
MILLER_BITS = [int(c) for c in bin(bn.ATE_LOOP_COUNT)[2:]][1:]
STEPS = len(MILLER_BITS)
# A variable pair's lines in the order the Miller loop takes them (a
# tangent a step, a chord where the bit is set, two corrections), each a
# row (l00, l10, l11) of 2 x 8 32-bit words per coefficient: the rows
# kernel g2_lines writes for K3 (ops/pairing_cuda.py::g2_lines).
VAR_ROWS = STEPS + sum(MILLER_BITS) + 2
LINE_ROW_WORDS = 3 * 2 * 8


class G2LineTable(NamedTuple):
    """Montgomery-limb line coefficients of one fixed G2 point.

    dbl_*: (STEPS, 16, 2) tangent line of iteration i.
    add_*: (STEPS, 16, 2) chord line of iteration i, zeros where
           MILLER_BITS[i] == 0.
    tail_*: (2, 16, 2) the q1/q2 Frobenius correction lines.
    """

    dbl_c1: np.ndarray
    dbl_c3: np.ndarray
    add_c1: np.ndarray
    add_c3: np.ndarray
    tail_c1: np.ndarray
    tail_c3: np.ndarray


def _pack_fq2(v) -> np.ndarray:
    """Oracle Fq2 tuple -> (16, 2) Montgomery limbs."""
    return np.stack([FQ.pack_scalar(v[0]), FQ.pack_scalar(v[1])], axis=1)


def _tangent_coeffs(t):
    xt, yt = t
    lam = bn.fq2_mul(
        bn.fq2_mul_scalar(bn.fq2_sq(xt), 3),
        bn.fq2_inv(bn.fq2_mul_scalar(yt, 2)),
    )
    return bn.fq2_neg(lam), bn.fq2_sub(bn.fq2_mul(lam, xt), yt)


def _chord_coeffs(t, q):
    xt, yt = t
    xq, yq = q
    if xt == xq:
        raise ValueError("vertical line for a VK G2 point (t == +-q): invalid VK")
    lam = bn.fq2_mul(bn.fq2_sub(yq, yt), bn.fq2_inv(bn.fq2_sub(xq, xt)))
    return bn.fq2_neg(lam), bn.fq2_sub(bn.fq2_mul(lam, xt), yt)


def g2_line_table(q) -> G2LineTable:
    """Walk the optimal-ate schedule for a fixed Q: per iteration the
    tangent, then the chord where the bit is set; then the corrections
    by q1 = pi(Q) and q2 = -pi^2(Q)."""
    if q is None or not bn.g2_is_on_curve(q):
        raise ValueError("fixed G2 point is infinity or off the curve")
    zero2 = np.zeros((16, 2), dtype=np.int32)
    dbl_c1, dbl_c3, add_c1, add_c3 = [], [], [], []
    t = q
    for bit in MILLER_BITS:
        c1, c3 = _tangent_coeffs(t)
        dbl_c1.append(_pack_fq2(c1))
        dbl_c3.append(_pack_fq2(c3))
        t = bn.g2_add(t, t)
        if bit:
            c1, c3 = _chord_coeffs(t, q)
            add_c1.append(_pack_fq2(c1))
            add_c3.append(_pack_fq2(c3))
            t = bn.g2_add(t, q)
        else:
            add_c1.append(zero2)
            add_c3.append(zero2)
    q1 = bn.g2_frobenius(q)
    q2 = bn.g2_neg(bn.g2_frobenius(bn.g2_frobenius(q)))
    tail_c1, tail_c3 = [], []
    for qq in (q1, q2):
        c1, c3 = _chord_coeffs(t, qq)
        tail_c1.append(_pack_fq2(c1))
        tail_c3.append(_pack_fq2(c3))
        t = bn.g2_add(t, qq)
    return G2LineTable(
        dbl_c1=np.stack(dbl_c1),
        dbl_c3=np.stack(dbl_c3),
        add_c1=np.stack(add_c1),
        add_c3=np.stack(add_c3),
        tail_c1=np.stack(tail_c1),
        tail_c3=np.stack(tail_c3),
    )


def tables_from_numpy(tables: Sequence, device="cpu"):
    """Line tables (this module's or the JAX package's G2LineTable, any
    tuple with the same fields of numpy arrays) -> the tensors the Miller
    product takes: lines (nf, 4, STEPS, 16, 2) with rows (dbl_c1, dbl_c3,
    add_c1, add_c3), and tails (nf, 2, 2, 16, 2) as (c1/c3, step, ...),
    both int32 on ``device``."""
    lines = np.stack([
        np.stack([np.asarray(tb.dbl_c1), np.asarray(tb.dbl_c3),
                  np.asarray(tb.add_c1), np.asarray(tb.add_c3)])
        for tb in tables
    ])
    tails = np.stack([
        np.stack([np.asarray(tb.tail_c1), np.asarray(tb.tail_c3)])
        for tb in tables
    ])
    return (
        torch.as_tensor(lines.astype(np.int32), device=device),
        torch.as_tensor(tails.astype(np.int32), device=device),
    )

"""PyTorch port, curve layer: the main path's G2 on-curve mask against the
JAX package, and the plain twin of kernel K2 (windowed MSM -> affine)
against the oracle and against the JAX package's XLA tier. Exact."""

import random

import jax
import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.models import jax_backend as JB
from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu.ops import curve as JC
from snark_bn254_verifier_tpu_torch.models.packing import pack_g1, pack_g2, unpack_fq
from snark_bn254_verifier_tpu_torch.ops import curve as C
from snark_bn254_verifier_tpu_torch.ops import field_cuda as FC
from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC
from snark_bn254_verifier_tpu_torch.ops.limbs import FR


def tensors(tup):
    return tuple(torch.as_tensor(x) for x in tup)


def test_g2_on_curve_mask_matches_jax():
    rng = random.Random(11)
    pts = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(3)]
    off = (pts[1][0], bn.fq2_add(pts[1][1], (1, 0)))  # y moved off the curve
    lanes = [pts[0], off, None, pts[2]]
    x, y, inf = pack_g2(lanes)
    got = C.is_on_curve_affine(C.G2_OPS, tensors((x, y, inf)))
    want = JC.is_on_curve_affine(JC.G2_OPS, (x.astype(np.uint32), y.astype(np.uint32), inf))
    assert got.tolist() == [True, False, True, True]
    assert got.tolist() == np.asarray(want).tolist()
    # the same mask through the K1 wrapper (plain on CPU tensors)
    k1_ops = C.g2_ops(FC.fq_mul)
    assert C.is_on_curve_affine(k1_ops, tensors((x, y, inf))).tolist() == got.tolist()


def msm_case(seed, b=4):
    """Three points per lane with infinity points, zero scalars and r - 1."""
    rng = random.Random(seed)
    pts = [[bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(b)]
           for _ in range(3)]
    sc = [[rng.randrange(bn.R) for _ in range(b)] for _ in range(3)]
    for j in range(3):
        sc[j][0] = 0                  # lane 0: zero scalars -> infinity
    pts[1][1] = None                  # lane 1: an infinite point
    sc[2][1] = bn.R - 1               # ... and scalar r - 1
    pts[1][2] = pts[2][2] = pts[0][2]  # lane 2: one point thrice (doubling)
    sc[1][2] = sc[2][2] = sc[0][2]
    pts[1][3] = bn.g1_neg(pts[0][3])  # lane 3: P + (-P) + third point
    sc[1][3] = sc[0][3]
    packed = [pack_g1(p) for p in pts]
    points = tuple(np.stack([p[i] for p in packed]) for i in range(3))
    scalars = np.stack([FR.pack(s, mont=False) for s in sc])
    return pts, sc, points, scalars


def oracle_msm(pts, sc, lane):
    keep = [j for j in range(len(pts)) if pts[j][lane] is not None]
    return bn.g1_msm([pts[j][lane] for j in keep], [sc[j][lane] for j in keep])


def test_msm_affine_plain_twin_matches_oracle():
    pts, sc, points, scalars = msm_case(12)
    x, y, inf = PC.msm_affine(tensors(points), torch.as_tensor(scalars))
    assert x.dtype == torch.int32 and inf.dtype == torch.bool
    xs, ys = unpack_fq(x.numpy()), unpack_fq(y.numpy())
    for lane in range(4):
        got = None if inf[lane] else (xs[lane], ys[lane])
        assert got == oracle_msm(pts, sc, lane), lane
    assert bool(inf[0])
    assert x[:, 0].eq(0).all() and y[:, 0].eq(0).all()  # infinity is (0, 0, True)


@pytest.mark.slow  # XLA:CPU compile of the windowed scan, as tests/test_msm.py
def test_msm_affine_matches_jax_xla_tier():
    _, _, points, scalars = msm_case(13)
    u32 = tuple(p.astype(np.uint32) if p.dtype != bool else p for p in points)
    ref = jax.jit(lambda p, s: JC.to_affine(JC.G1_OPS, JC.msm_windowed(JC.G1_OPS, p, s)))(
        u32, scalars.astype(np.uint32))
    got = PC.msm_affine(tensors(points), torch.as_tensor(scalars))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy().astype(np.int64), np.asarray(r).astype(np.int64))
    assert JB.unpack_fq(np.asarray(ref[0])) == unpack_fq(got[0].numpy())

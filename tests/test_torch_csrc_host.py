"""The CUDA kernels' arithmetic, built for the host: csrc/*.cuh compiled by
the host C++ compiler into a test-only library (csrc/host_check.cc) and run
lane by lane against the oracle. Covers the 16<->32-bit limb conversion,
the 32-bit CIOS, the tower, the MSM lane, a final_exp(miller_mixed) lane
and K5's Miller-product lane without a card. Skips where no host C++
compiler is installed."""

import random
import shutil

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu_torch.models.packing import (
    pack_fq12,
    pack_g1,
    pack_g2,
    pair_major,
    unpack_fq,
    unpack_fq12,
)
from snark_bn254_verifier_tpu_torch.ops import field as F
from snark_bn254_verifier_tpu_torch.ops import lines as LN
from snark_bn254_verifier_tpu_torch.ops.limbs import FQ, FR


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    from snark_bn254_verifier_tpu_torch.ops import _build

    return _build.load_host_check()


def ptr(t):
    return t.data_ptr()


def c_tensor(x):
    return torch.as_tensor(np.ascontiguousarray(x)).contiguous()


@pytest.mark.parametrize("name", ["fq", "fr"])
def test_fp_mul_matches_oracle_and_plain_twin(lib, name):
    spec = FQ if name == "fq" else FR
    rng = random.Random(51)
    va = [rng.randrange(spec.modulus) for _ in range(6)] + [0, spec.modulus - 1]
    vb = [rng.randrange(spec.modulus) for _ in range(6)] + [spec.modulus - 1, spec.modulus - 1]
    a, b = c_tensor(spec.pack(va)), c_tensor(spec.pack(vb))
    out = torch.empty_like(a)
    assert lib.host_mont_mul(ptr(a), ptr(b), ptr(out), a.shape[1], 0 if name == "fq" else 1) == 0
    assert spec.unpack(out.numpy()) == [x * y % spec.modulus for x, y in zip(va, vb)]
    assert torch.equal(out, F.mont_mul(spec, a, b))


def test_fq12_mul_matches_oracle(lib):
    rng = random.Random(52)

    def rand12():
        return tuple(tuple((rng.randrange(bn.P), rng.randrange(bn.P)) for _ in range(3))
                     for _ in range(2))

    xs, ys = [rand12() for _ in range(3)], [rand12() for _ in range(3)]
    a, b = c_tensor(pack_fq12(xs)), c_tensor(pack_fq12(ys))
    out = torch.empty_like(a)
    assert lib.host_fq12_mul(ptr(a), ptr(b), ptr(out), 3) == 0
    assert unpack_fq12(out.numpy()) == [bn.fq12_mul(x, y) for x, y in zip(xs, ys)]


def test_msm_affine_lane_matches_oracle(lib):
    rng = random.Random(53)
    pts = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(3)]
    # lane 0: three points; lane 1: a repeated point (doubling) and infinity
    lanes = [pts, [pts[0], pts[0], None]]
    scal = [[rng.randrange(bn.R) for _ in range(3)], [5, 5, 7]]
    packed = [pack_g1([lanes[l][j] for l in range(2)]) for j in range(3)]
    px = c_tensor(np.stack([p[0] for p in packed]))
    py = c_tensor(np.stack([p[1] for p in packed]))
    pinf = c_tensor(np.stack([p[2] for p in packed]).astype(np.uint8))
    sc = c_tensor(np.stack([FR.pack([scal[l][j] for l in range(2)], mont=False) for j in range(3)]))
    ox = torch.empty((16, 2), dtype=torch.int32)
    oy, oinf = torch.empty_like(ox), torch.empty(2, dtype=torch.uint8)
    assert lib.host_msm_affine(ptr(px), ptr(py), ptr(pinf), ptr(sc), 3,
                               ptr(ox), ptr(oy), ptr(oinf), 2) == 0
    xs, ys = unpack_fq(ox.numpy()), unpack_fq(oy.numpy())
    for lane in range(2):
        keep = [j for j in range(3) if lanes[lane][j] is not None]
        want = bn.g1_msm([lanes[lane][j] for j in keep], [scal[lane][j] for j in keep])
        assert (None if oinf[lane] else (xs[lane], ys[lane])) == want


def test_final_exp_of_miller_mixed_lane_matches_oracle(lib):
    rng = random.Random(54)
    q_fixed = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    lines, tails = LN.tables_from_numpy([LN.g2_line_table(q) for q in q_fixed])
    lines, tails = lines.contiguous(), tails.contiguous()
    fixed = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    vp = bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R))
    vq = bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R))
    px, py, _ = (c_tensor(a) for a in pack_g1([vp]))
    qx, qy, _ = (c_tensor(a) for a in pack_g2([vq]))
    fp = [pack_g1([p]) for p in fixed]
    fpx = c_tensor(np.stack([p[0] for p in fp]))
    fpy = c_tensor(np.stack([p[1] for p in fp]))
    f = torch.empty((16, 12, 1), dtype=torch.int32)
    assert lib.host_miller_mixed(ptr(px), ptr(py), ptr(qx), ptr(qy), ptr(fpx), ptr(fpy),
                                 2, ptr(lines), ptr(tails), ptr(f), 1) == 0
    gt = torch.empty_like(f)
    assert lib.host_final_exp(ptr(f), ptr(gt), 1) == 0
    want = bn.pairing_batch([(fixed[0], q_fixed[0]), (fixed[1], q_fixed[1]), (vp, vq)])
    assert unpack_fq12(gt.numpy()) == [want]


def test_msm_affine_lane_combines_point_groups(lib):
    """More points than one Straus group (MSM_GROUP = 4): the lane sums
    the groups' partials, as the VK of an 8-input circuit needs (9 points)."""
    rng = random.Random(55)
    n = 9
    lanes = [[bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(n)] for _ in range(2)]
    lanes[1][4] = None  # an infinite point in the second group
    scal = [[rng.randrange(bn.R) for _ in range(n)] for _ in range(2)]
    scal[1][8] = 0      # the last, single-point group adds nothing
    packed = [pack_g1([lanes[l][j] for l in range(2)]) for j in range(n)]
    px = c_tensor(np.stack([p[0] for p in packed]))
    py = c_tensor(np.stack([p[1] for p in packed]))
    pinf = c_tensor(np.stack([p[2] for p in packed]).astype(np.uint8))
    sc = c_tensor(np.stack([FR.pack([scal[l][j] for l in range(2)], mont=False) for j in range(n)]))
    ox = torch.empty((16, 2), dtype=torch.int32)
    oy, oinf = torch.empty_like(ox), torch.empty(2, dtype=torch.uint8)
    assert lib.host_msm_affine(ptr(px), ptr(py), ptr(pinf), ptr(sc), n,
                               ptr(ox), ptr(oy), ptr(oinf), 2) == 0
    xs, ys = unpack_fq(ox.numpy()), unpack_fq(oy.numpy())
    for lane in range(2):
        keep = [j for j in range(n) if lanes[lane][j] is not None]
        want = bn.g1_msm([lanes[lane][j] for j in keep], [scal[lane][j] for j in keep])
        assert (None if oinf[lane] else (xs[lane], ys[lane])) == want


def test_miller_mixed_lanes_with_infinite_pairs_equal_plain_twin(lib):
    """Infinite pairs go through the same calls as the others, with the
    line (1, 0, 0): the Miller value stays limb-equal to the plain twin."""
    from snark_bn254_verifier_tpu_torch.ops import pairing as PR

    rng = random.Random(56)
    q_fixed = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    lines, tails = LN.tables_from_numpy([LN.g2_line_table(q) for q in q_fixed])
    lines, tails = lines.contiguous(), tails.contiguous()
    g1 = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(4)]
    g2 = bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R))
    # lanes: all pairs finite; var P infinite; var Q infinite; both fixed P infinite
    vp = [g1[0], None, g1[1], g1[2]]
    vq = [g2, g2, None, g2]
    fl = [[g1[3], g1[3], g1[0], None], [g1[1], g1[2], g1[3], None]]
    var_p, var_q = (c_tensor(a) for a in pack_g1(vp)), (c_tensor(a) for a in pack_g2(vq))
    var_p, var_q = tuple(var_p), tuple(var_q)
    fixed = tuple(tuple(c_tensor(a) for a in pack_g1(l)) for l in fl)
    want = PR.miller_mixed(var_p, var_q, fixed, lines, tails)
    # the kernel's inputs: infinite lanes zeroed (as ops/pairing_cuda.py does)
    skip = var_p[2] | var_q[2]
    px, py = (torch.where(skip, 0, t).contiguous() for t in var_p[:2])
    qx, qy = (torch.where(skip, 0, t).contiguous() for t in var_q[:2])
    fpx = c_tensor(torch.stack([torch.where(inf, 0, x) for x, _, inf in fixed]))
    fpy = c_tensor(torch.stack([torch.where(inf, 0, y) for _, y, inf in fixed]))
    f = torch.empty((16, 12, 4), dtype=torch.int32)
    assert lib.host_miller_mixed(ptr(px), ptr(py), ptr(qx), ptr(qy), ptr(fpx), ptr(fpy),
                                 2, ptr(lines), ptr(tails), ptr(f), 4) == 0
    assert torch.equal(f, want)


def test_miller_product_lanes_with_infinite_pairs_equal_plain_twin(lib):
    """K5's lane for 1, 3 and 5 pairs (5: two groups on two shared chains)
    is limb-equal to the plain twin's product of separate Miller loops.
    Infinite pairs go through the same calls with the line (1, 0, 0)."""
    from snark_bn254_verifier_tpu_torch.ops import pairing as PR
    from snark_bn254_verifier_tpu_torch.ops import tower as T

    rng = random.Random(57)
    g1 = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(4)]
    g2 = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(3)]
    n, b = 5, 4
    # lanes: all finite; the first P infinite; the second Q infinite; the
    # last pair (in the second group) and the third P infinite
    ps = [[g1[(i + j) % 4] for i in range(b)] for j in range(n)]
    qs = [[g2[(i + 2 * j) % 3] for i in range(b)] for j in range(n)]
    ps[0][1] = None
    qs[1][2] = None
    ps[4][3] = qs[4][3] = ps[2][3] = None
    P = tuple(c_tensor(a) for a in pair_major(pack_g1, ps))
    Q = tuple(c_tensor(a) for a in pair_major(pack_g2, qs))
    # the twin's per-pair Miller values of all five pairs in one loop; the
    # products of the first 1, 3 and 5 are those of PR.miller_product
    f = PR.miller_loop((P[0].movedim(0, 1), P[1].movedim(0, 1), P[2]),
                       (Q[0].movedim(0, 2), Q[1].movedim(0, 2), Q[2]))
    # the kernel's inputs: infinite pairs zeroed (as ops/pairing_cuda.py does)
    skip = P[2] | Q[2]
    px, py = (c_tensor(torch.where(skip[:, None], 0, t)) for t in P[:2])
    qx, qy = (c_tensor(torch.where(skip[:, None, None], 0, t)) for t in Q[:2])
    acc = f[:, :, 0]
    for k in range(1, n + 1):
        if k > 1:
            acc = T.fq12_mul(acc, f[:, :, k - 1])
        if k not in (1, 3, 5):
            continue
        out = torch.empty((16, 12, b), dtype=torch.int32)
        assert lib.host_miller_product(ptr(px), ptr(py), ptr(qx), ptr(qy), k, ptr(out), b) == 0
        assert torch.equal(out, acc.to(torch.int32)), k

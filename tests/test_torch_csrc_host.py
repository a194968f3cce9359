"""The CUDA kernels' arithmetic, built for the host: csrc/*.cuh compiled by
the host C++ compiler into a test-only library (csrc/host_check.cc) and run
against the oracle and the plain twins, the team kernels with one host
thread per team thread. Covers the 16<->32-bit limb conversion, the 32-bit
CIOS, the fused K1's G2 on-curve mask, the teams' Fq12 product, K2's MSM
team, the fixed-base MSM's team, final_exp(miller_mixed) over g2_lines'
rows (tests/test_torch_g2_lines.py has g2_lines' own), K5's Miller-product team, K6's six
stages (the counting sort, the chunked bucket sums and their merge, the
window sums, the combine of k sets), and K7's blocks stage by stage with
its divsteps inverse, without a card, each kernel's code with the form of
the Montgomery product its unit runs on the card. Skips where no host C++
compiler is installed."""

import ctypes
import random

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu_torch.fixtures.g2_lanes import g2_mask_lanes
from snark_bn254_verifier_tpu_torch.models.packing import (
    pack_fq12,
    pack_fr_columns,
    pack_g1,
    pack_g2,
    pair_major,
    unpack_fq,
    unpack_fq12,
)
from snark_bn254_verifier_tpu_torch.ops import field as F
from snark_bn254_verifier_tpu_torch.ops import lines as LN
from snark_bn254_verifier_tpu_torch.ops.limbs import FQ, FR
from torch_host_build import c_tensor, host_check, host_miller_mixed, ptr


@pytest.fixture(scope="module")
def lib():
    """Built with the unrolled Montgomery product, K1's, K3's and K4's."""
    return host_check(False)


@pytest.fixture(scope="module")
def lib_rolled():
    """Built with the rolled Montgomery product, K2's, K5's and g2_lines'."""
    return host_check(True)


@pytest.mark.parametrize("rolled", [0, 1])
@pytest.mark.parametrize("name", ["fq", "fr"])
def test_fp_mul_matches_oracle_and_plain_twin(lib, name, rolled):
    """The CIOS product in both forms (K2 and K5 run the rolled one)."""
    spec = FQ if name == "fq" else FR
    rng = random.Random(51)
    va = [rng.randrange(spec.modulus) for _ in range(6)] + [0, spec.modulus - 1]
    vb = [rng.randrange(spec.modulus) for _ in range(6)] + [spec.modulus - 1, spec.modulus - 1]
    a, b = c_tensor(spec.pack(va)), c_tensor(spec.pack(vb))
    out = torch.empty_like(a)
    assert lib.host_mont_mul(ptr(a), ptr(b), ptr(out), a.shape[1],
                             0 if name == "fq" else 1, rolled) == 0
    assert spec.unpack(out.numpy()) == [x * y % spec.modulus for x, y in zip(va, vb)]
    assert torch.equal(out, F.mont_mul(spec, a, b))


@pytest.mark.parametrize("binary", [0, 1])
def test_fq_inverse_matches_oracle(lib, lib_rolled, binary):
    """Fermat (K4's) and binary Euclid (K2's) inverses of Montgomery
    elements, each with its kernel's product: limb-equal to the oracle's,
    zero to zero."""
    rng = random.Random(50)
    vals = [rng.randrange(bn.P) for _ in range(8)] + [0, 1, 2, bn.P - 1, 1 << 200]
    a = c_tensor(FQ.pack(vals))
    out = torch.empty_like(a)
    host = lib_rolled if binary else lib
    assert host.host_fq_inv(ptr(a), ptr(out), a.shape[1], binary) == 0
    assert FQ.unpack(out.numpy()) == [pow(v, bn.P - 2, bn.P) for v in vals]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fr_inverse_divsteps_equals_fermat_twin(lib, seed):
    """K7a's inverse (plonk.cuh::fr_inv: Bernstein-Yang divsteps, then a
    product by R^3) of Montgomery elements: limb-equal to the plain twin's
    Fermat a^(r-2) (ops/field.py::inv) and the oracle's, zero to zero, on
    seeded values and the edges 0, 1, r - 1 and values with their high
    words set."""
    rng = np.random.default_rng(70 + seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % bn.R for _ in range(24)]
    vals += [0, 1, 2, bn.R - 1, bn.R - 2, 1 << 253, bn.R - (1 << 200), (1 << 253) | 1,
             bn.R >> 1, (bn.R >> 32) << 32]
    a = c_tensor(FR.pack(vals))
    out = torch.empty_like(a)
    assert lib.host_fr_inv(ptr(a), ptr(out), a.shape[1]) == 0
    assert FR.unpack(out.numpy()) == [pow(v, bn.R - 2, bn.R) for v in vals]
    assert torch.equal(out, F.inv(FR, a.to(torch.int64)).to(torch.int32))


@pytest.mark.parametrize("n", [1, 33, 130])
def test_g2_on_curve_lanes_equal_plain_twin(lib, n):
    """The fused K1's lane body (curve.cuh::g2_on_curve_lane, K1's unrolled
    Montgomery product) over a ragged lane count, lane for lane equal to
    its plain twin and to the oracle's valid && (inf || on the curve)."""
    from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC

    x, y, inf, valid, want = g2_mask_lanes(80 + n, n)
    tx, ty, tinf, tvalid = (c_tensor(a) for a in (x, y, inf, valid))
    out = torch.empty(n, dtype=torch.bool)
    assert lib.host_g2_on_curve(ptr(tx), ptr(ty), ptr(tinf), ptr(tvalid), ptr(out), n) == 0
    assert torch.equal(out, PC.g2_on_curve((tx, ty, tinf), tvalid))
    assert out.tolist() == want
    if n > 1:
        assert 0 < sum(want) < n


def test_fq12_mul_matches_oracle(lib, lib_rolled):
    """team.cuh's Fq12 product as each team kernel runs it: K4's team of 12
    (8 lanes a block) and K3's of 18 (4 lanes a block) with the unrolled
    Montgomery product, K5's of 18 with the rolled one. 9 lanes (ragged
    blocks) of random values, zero, one and every coefficient p - 1."""
    rng = random.Random(52)

    def rand12():
        return tuple(tuple((rng.randrange(bn.P), rng.randrange(bn.P)) for _ in range(3))
                     for _ in range(2))

    top = tuple(tuple((bn.P - 1, bn.P - 1) for _ in range(3)) for _ in range(2))
    xs = [rand12() for _ in range(6)] + [bn.FQ12_ZERO, top, bn.FQ12_ONE]
    ys = [rand12() for _ in range(6)] + [rand12(), top, rand12()]
    a, b = c_tensor(pack_fq12(xs)), c_tensor(pack_fq12(ys))
    want = [bn.fq12_mul(x, y) for x, y in zip(xs, ys)]
    for host, team in ((lib, 12), (lib, 18), (lib_rolled, 18)):
        out = torch.empty_like(a)
        assert host.host_fq12_mul(ptr(a), ptr(b), ptr(out), len(xs), team) == 0
        assert unpack_fq12(out.numpy()) == want, (team, host is lib_rolled)


def test_msm_affine_lane_matches_oracle(lib_rolled):
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
    assert lib_rolled.host_msm_affine(ptr(px), ptr(py), ptr(pinf), ptr(sc), 3,
                                      ptr(ox), ptr(oy), ptr(oinf), 2) == 0
    xs, ys = unpack_fq(ox.numpy()), unpack_fq(oy.numpy())
    for lane in range(2):
        keep = [j for j in range(3) if lanes[lane][j] is not None]
        want = bn.g1_msm([lanes[lane][j] for j in keep], [scal[lane][j] for j in keep])
        assert (None if oinf[lane] else (xs[lane], ys[lane])) == want


def test_final_exp_of_miller_mixed_lane_matches_oracle(lib):
    """g2_lines, K3 over its rows, then K4, each on its team, for one lane
    (a ragged block)."""
    rng = random.Random(54)
    q_fixed = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    lines, tails = LN.tables_from_numpy([LN.g2_line_table(q) for q in q_fixed])
    lines, tails = lines.contiguous(), tails.contiguous()
    fixed = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    vp = bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R))
    vq = bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R))
    var_p = tuple(c_tensor(a) for a in pack_g1([vp]))
    var_q = tuple(c_tensor(a) for a in pack_g2([vq]))
    fp = tuple(tuple(c_tensor(a) for a in pack_g1([p])) for p in fixed)
    f = host_miller_mixed(lib, var_p, var_q, fp, lines, tails)
    gt = torch.empty_like(f)
    assert lib.host_final_exp(ptr(f), ptr(gt), 1) == 0
    want = bn.pairing_batch([(fixed[0], q_fixed[0]), (fixed[1], q_fixed[1]), (vp, vq)])
    assert unpack_fq12(gt.numpy()) == [want]


def test_msm_affine_lane_combines_point_groups(lib_rolled):
    """9 points, as the VK of an 8-input circuit needs: the team's threads
    each take a point and their partial sums are added in a tree."""
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
    assert lib_rolled.host_msm_affine(ptr(px), ptr(py), ptr(pinf), ptr(sc), n,
                                      ptr(ox), ptr(oy), ptr(oinf), 2) == 0
    xs, ys = unpack_fq(ox.numpy()), unpack_fq(oy.numpy())
    for lane in range(2):
        keep = [j for j in range(n) if lanes[lane][j] is not None]
        want = bn.g1_msm([lanes[lane][j] for j in keep], [scal[lane][j] for j in keep])
        assert (None if oinf[lane] else (xs[lane], ys[lane])) == want


@pytest.mark.parametrize("n", [4, 6])
def test_miller_mixed_lanes_with_infinite_pairs_equal_plain_twin(lib, n):
    """Infinite pairs go through the same calls as the others, with the
    line (1, 0, 0): the Miller value stays limb-equal to the plain twin.
    ``n`` lanes, a ragged block of MM_LPB = 8 (full and ragged blocks:
    tests/test_torch_g2_lines.py)."""
    from snark_bn254_verifier_tpu_torch.ops import pairing as PR

    rng = random.Random(56)
    q_fixed = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    lines, tails = LN.tables_from_numpy([LN.g2_line_table(q) for q in q_fixed])
    lines, tails = lines.contiguous(), tails.contiguous()
    g1 = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(4)]
    g2 = bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R))
    # lanes: all pairs finite; var P infinite; var Q infinite; both fixed
    # P infinite; then the same again
    vp = [[g1[0], None, g1[1], g1[2]][i % 4] for i in range(n)]
    vq = [[g2, g2, None, g2][i % 4] for i in range(n)]
    fl = [[[g1[3], g1[3], g1[0], None][i % 4] for i in range(n)],
          [[g1[1], g1[2], g1[3], None][i % 4] for i in range(n)]]
    var_p, var_q = (c_tensor(a) for a in pack_g1(vp)), (c_tensor(a) for a in pack_g2(vq))
    var_p, var_q = tuple(var_p), tuple(var_q)
    fixed = tuple(tuple(c_tensor(a) for a in pack_g1(l)) for l in fl)
    want = PR.miller_mixed(var_p, var_q, fixed, lines, tails)
    assert torch.equal(host_miller_mixed(lib, var_p, var_q, fixed, lines, tails), want)


def test_miller_product_lanes_with_infinite_pairs_equal_plain_twin(lib_rolled):
    """K5's team for 1, 3 and 5 pairs (5: two passes of its MP_CHAINS = 4
    chains, one pair each) is limb-equal to the plain twin's product of
    separate Miller loops. Infinite pairs go through the same rounds with
    the line (1, 0, 0)."""
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
        assert lib_rolled.host_miller_product(ptr(px), ptr(py), ptr(qx), ptr(qy), k,
                                              ptr(out), b) == 0
        assert torch.equal(out, acc.to(torch.int32)), k


@pytest.mark.parametrize("n", [3, 5])
def test_miller_mixed_fixed_only_equals_plain_twin(lib, n):
    """K3 with no variable pair (PlonK's shape): null pointers for it, two
    fixed pairs, one of them at infinity on lane 1. ``n`` lanes in a
    ragged block of MM_LPB = 8."""
    from snark_bn254_verifier_tpu_torch.ops import pairing as PR

    rng = random.Random(58)
    q_fixed = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    lines, tails = LN.tables_from_numpy([LN.g2_line_table(q) for q in q_fixed])
    lines, tails = lines.contiguous(), tails.contiguous()
    g1 = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(3)]
    fl = [[[g1[0], None, g1[2]][i % 3] for i in range(n)],
          [[g1[1], g1[2], g1[0]][i % 3] for i in range(n)]]
    fixed = tuple(tuple(c_tensor(a) for a in pack_g1(l)) for l in fl)
    want = PR.miller_mixed(None, None, fixed, lines, tails)
    assert torch.equal(host_miller_mixed(lib, None, None, fixed, lines, tails), want)


@pytest.mark.parametrize("n", [4, 9])
def test_final_exp_team_on_arbitrary_lanes_equals_plain_twin(lib, n):
    """K4 on what a bad lane may hold: zero, one and random Fq12 values
    (not in the cyclotomic subgroup), limb-equal to the plain twin. ``n``
    lanes in blocks of FE_LPB = 8: a ragged block alone, or after a full
    one."""
    from snark_bn254_verifier_tpu_torch.ops import pairing as PR

    rng = np.random.default_rng(59)
    limbs = rng.integers(0, 1 << 16, size=(16, 12, n), dtype=np.int64)
    limbs[15] = rng.integers(0, bn.P >> 240, size=(12, n))
    f = c_tensor(limbs.astype(np.int32))
    f[:, :, 0] = 0
    f[:, :, 1] = c_tensor(pack_fq12([bn.FQ12_ONE]))[:, :, 0]
    f = f.contiguous()
    out = torch.empty_like(f)
    assert lib.host_final_exp(ptr(f), ptr(out), n) == 0
    assert torch.equal(out, PR.final_exp(f).to(torch.int32))


def msm_edge_lanes(rng, n, b):
    """n points over b lanes with random scalars and, where n allows, the
    edge lanes of chip_smoke.py: 0 zero scalars, 1 an infinite point, 2
    scalar r - 1, 3 one point thrice (the sums double), 4 P + (-P)."""
    pool = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(5)]
    lanes = [[pool[(i + j) % 5] for i in range(b)] for j in range(n)]
    scal = [[rng.randrange(bn.R) for _ in range(b)] for _ in range(n)]
    for j in range(n):
        scal[j][0] = 0
    lanes[n - 1][1] = None
    scal[0][2] = bn.R - 1
    for j in range(1, min(n, 3)):
        lanes[j][3], scal[j][3] = lanes[0][3], scal[0][3]
    if n >= 2:
        lanes[1][4], scal[1][4] = bn.g1_neg(lanes[0][4]), scal[0][4]
    return lanes, scal


@pytest.mark.parametrize("n", [1, 2, 7, 11, 17])
def test_msm_affine_team_edge_lanes_match_oracle(lib_rolled, n):
    """K2's team on PlonK's MSM sizes (11, 7, 2, 1 points) and on 17 (two
    passes of the 16-thread team), over 9 lanes in blocks of MSM_LPB = 2
    (the last block ragged), with the edge lanes; the affine result is
    unique, so equality with the oracle is limb-equality."""
    b = 9
    lanes, scal = msm_edge_lanes(random.Random(60 + n), n, b)
    packed = [pack_g1(l) for l in lanes]
    px = c_tensor(np.stack([p[0] for p in packed]))
    py = c_tensor(np.stack([p[1] for p in packed]))
    pinf = c_tensor(np.stack([p[2] for p in packed]).astype(np.uint8))
    sc = c_tensor(np.stack([FR.pack(s, mont=False) for s in scal]))
    ox = torch.empty((16, b), dtype=torch.int32)
    oy, oinf = torch.empty_like(ox), torch.empty(b, dtype=torch.uint8)
    assert lib_rolled.host_msm_affine(ptr(px), ptr(py), ptr(pinf), ptr(sc), n,
                                      ptr(ox), ptr(oy), ptr(oinf), b) == 0
    xs, ys = unpack_fq(ox.numpy()), unpack_fq(oy.numpy())
    for lane in range(b):
        keep = [j for j in range(n) if lanes[j][lane] is not None]
        want = bn.g1_msm([lanes[j][lane] for j in keep], [scal[j][lane] for j in keep])
        got = None if oinf[lane] else (xs[lane], ys[lane])
        assert got == want, lane
        if want is None:
            assert xs[lane] == ys[lane] == 0


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_msm_fixed_team_equals_plain_twin_and_oracle(lib_rolled, n):
    """The fixed-base MSM's team (msm_fixed.cuh) over 9 lanes in blocks of
    FX_LPB = 4 (the last ragged), with the edge lanes of
    fixtures/msm_lanes.py::fixed_base_lanes and a point at infinity;
    n = 2 and 3 leave some of the 16 threads without a pair in the last
    step, 5 gives every thread ten; limb-equal to the plain twin, and each
    lane to the oracle."""
    from snark_bn254_verifier_tpu_torch.fixtures.msm_lanes import fixed_base_lanes
    from snark_bn254_verifier_tpu_torch.models.packing import unpack_g1
    from snark_bn254_verifier_tpu_torch.ops import msm as M

    b = 9
    pts, scs, logs = fixed_base_lanes(n, b, 100 + n)
    table = M.fixed_table_plain(tuple(torch.as_tensor(a) for a in pack_g1(pts)))
    sc = c_tensor(np.stack([FR.pack(s, mont=False) for s in scs]))
    ox = torch.empty((16, b), dtype=torch.int32)
    oy, oinf = torch.empty_like(ox), torch.empty(b, dtype=torch.uint8)
    assert lib_rolled.host_msm_fixed(ptr(table), ptr(sc), n, ptr(ox), ptr(oy), ptr(oinf),
                                     b) == 0
    want = M.msm_fixed_plain(table, sc)
    assert torch.equal(ox, want[0]) and torch.equal(oy, want[1])
    assert torch.equal(oinf.bool(), want[2])
    got = unpack_g1(ox, oy, oinf.bool())
    for lane in range(b):
        k = sum(s[lane] * log for s, log in zip(scs, logs)) % bn.R
        assert got[lane] == (bn.g1_mul(bn.G1_GEN, k) if k else None), lane


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_miller_product_team_ragged_block_equals_plain_twin(lib_rolled, n):
    """K5's team over 5 lanes, limb-equal to the plain twin; lane 1 has an
    infinite P, lane 2 an infinite Q on the last pair, lane 3 every pair
    infinite; chains without a pair (n < 4) multiply by one."""
    from snark_bn254_verifier_tpu_torch.ops import pairing as PR

    rng = random.Random(70 + n)
    b = 5
    g1 = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(3)]
    g2 = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    ps = [[g1[(i + j) % 3] for i in range(b)] for j in range(n)]
    qs = [[g2[(i + j) % 2] for i in range(b)] for j in range(n)]
    ps[0][1] = None
    qs[n - 1][2] = None
    for j in range(n):
        ps[j][3] = None
    P = tuple(c_tensor(a) for a in pair_major(pack_g1, ps))
    Q = tuple(c_tensor(a) for a in pair_major(pack_g2, qs))
    want = PR.miller_product(P, Q)
    # the kernel's inputs: infinite pairs zeroed (as ops/pairing_cuda.py does)
    skip = P[2] | Q[2]
    px, py = (c_tensor(torch.where(skip[:, None], 0, t)) for t in P[:2])
    qx, qy = (c_tensor(torch.where(skip[:, None, None], 0, t)) for t in Q[:2])
    out = torch.empty((16, 12, b), dtype=torch.int32)
    assert lib_rolled.host_miller_product(ptr(px), ptr(py), ptr(qx), ptr(qy), n, ptr(out), b) == 0
    assert torch.equal(out, want)


def oracle_msm_lanes(lanes, scal):
    """bn.g1_msm per lane over its distinct points, their scalars summed
    mod r (the same sum; the lanes draw from small pools)."""
    out = []
    for lane in range(len(lanes[0])):
        agg = {}
        for j in range(len(lanes)):
            if lanes[j][lane] is not None:
                agg[lanes[j][lane]] = (agg.get(lanes[j][lane], 0) + scal[j][lane]) % bn.R
        out.append(bn.g1_msm(list(agg), list(agg.values())))
    return out


def msm_tensors(lanes, scal):
    P = tuple(c_tensor(a) for a in pair_major(pack_g1, lanes))
    return P, c_tensor(np.stack([FR.pack(s, mont=False) for s in scal]))


def host_pippenger(lib, P, sc, c, chunk):
    """K6's six stages on the host (pippenger.cuh, host_check.cc), on one
    scratch buffer laid out as the card's: (affine result, window sums,
    scratch, the regions' byte offsets)."""
    n, _, b = P[0].shape
    off = (ctypes.c_longlong * 8)()
    scratch = torch.zeros(lib.host_pip_layout(n, c, b, chunk, off), dtype=torch.uint8)
    wsum = torch.empty((b, (256 + c - 1) // c, 24), dtype=torch.int32)
    ox = torch.empty((16, b), dtype=torch.int32)
    oy, oinf = torch.empty_like(ox), torch.empty(b, dtype=torch.bool)
    pinf = c_tensor(P[2].to(torch.uint8))
    assert lib.host_msm_pippenger(ptr(P[0]), ptr(P[1]), ptr(pinf), ptr(sc), n, c, chunk,
                                  ptr(scratch), ptr(wsum), ptr(ox), ptr(oy), ptr(oinf), b) == 0
    return (ox, oy, oinf), wsum, scratch, list(off)


def assert_msm_exact(got, P, sc, c, lanes, scal):
    """Limb-equal to the plain twin (ops/msm.py::pippenger_plain) and to
    the oracle, lane by lane."""
    from snark_bn254_verifier_tpu_torch.ops import msm as M

    want = M.pippenger_plain(P, sc, c)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    xs, ys = unpack_fq(got[0].numpy()), unpack_fq(got[1].numpy())
    pts = [None if got[2][lane] else (xs[lane], ys[lane]) for lane in range(len(xs))]
    assert pts == oracle_msm_lanes(lanes, scal)


@pytest.mark.parametrize("n,c", [(1, 2), (5, 4), (70, 3), (33, 5)])
def test_msm_pippenger_lanes_equal_plain_twin(lib_rolled, n, c):
    """K6's stages (pippenger.cuh: the digits and their counting sort, the
    bucket sums over chunks of 32 entries and their merge, a block of host
    threads per (lane, window) for the window sums, the combine on teams
    of host threads; the rolled Montgomery product, the bucket stages')
    over 5 lanes with the edge lanes of msm_edge_lanes: limb-equal to the
    plain twin and to the oracle. Narrow windows keep a reduction block to
    2^c host threads (c = 8 runs 256 a block, on the card in
    tests/test_torch_gpu.py and chip_smoke.py)."""
    lanes, scal = msm_edge_lanes(random.Random(90 + n), n, 5)
    P, sc = msm_tensors(lanes, scal)
    got, _, _, _ = host_pippenger(lib_rolled, P, sc, c, 32)
    assert_msm_exact(got, P, sc, c, lanes, scal)


@pytest.mark.parametrize("n,c,b", [(1, 2, 3), (70, 3, 2), (40, 8, 2), (300, 5, 1), (20, 14, 2)])
def test_pippenger_counting_sort_equals_bucket_order(lib_rolled, n, c, b):
    """K6's digit pass and counting sort (stages 1-2): ``starts`` and the
    sorted digits equal ops/msm.py::bucket_order's, and each bucket's run
    holds the same points (its order inside a bucket comes from atomic
    adds). c = 14 counts in global scratch, not shared memory; lane 0 has
    a point at infinity (digit 0 in every window)."""
    from snark_bn254_verifier_tpu_torch.ops import msm as M

    lanes, scal = msm_edge_lanes(random.Random(95 + n + c), n, 5)
    lanes, scal = [row[:b] for row in lanes], [row[:b] for row in scal]
    scal = [[random.Random(j).randrange(bn.R) for _ in row] for j, row in enumerate(scal)]
    lanes[0][0] = None
    P, sc = msm_tensors(lanes, scal)
    pinf = c_tensor(P[2].to(torch.uint8))
    off = (ctypes.c_longlong * 8)()
    scratch = torch.zeros(lib_rolled.host_pip_layout(n, c, b, 32, off), dtype=torch.uint8)
    assert lib_rolled.host_pip_sort(ptr(sc), ptr(pinf), n, c, 32, ptr(scratch), b) == 0
    w, nb1 = M.windows(c), (1 << c) + 1

    def region(i, count, dtype):
        size = torch.empty(0, dtype=dtype).element_size()
        return scratch[off[i]:off[i] + count * size].view(dtype).to(torch.int64)

    order = region(1, b * w * n, torch.int32).view(b, w, n)
    sdig = region(2, b * w * n, torch.int16).view(b, w, n) & 0xFFFF
    starts = region(3, b * w * nb1, torch.int32).view(b, w, nb1)
    digits, want_order, want_starts = M.bucket_order(P[2], sc, c)
    assert torch.equal(starts, want_starts) and torch.equal(sdig, digits)
    for lane in range(b):
        for win in range(w):
            for j in torch.nonzero(want_starts[lane, win, 1:] - want_starts[lane, win, :-1]):
                lo, hi = want_starts[lane, win, j], want_starts[lane, win, j + 1]
                got = sorted(order[lane, win, lo:hi].tolist())
                assert got == sorted(want_order[lane, win, lo:hi].tolist()), (lane, win, j)


def chunk_case(kind):
    """(lanes, scal, c, chunk) of one bucket-stage case, from a pool of
    five points: ``split`` runs of about 50 points over chunks of 3;
    ``chunk1`` a chunk per entry; ``whole`` chunks of 1000 entries holding
    many whole buckets; ``zero_lanes`` lanes 0 and 2 of all-zero scalars;
    ``infinity`` a third of the points at infinity; ``repeat`` one point
    throughout (each bucket adds P + P); ``lanes`` six lanes side by
    side; ``narrow`` 24 lanes, 1,032 rows, so the reduction takes narrow
    blocks (PIP_NARROW threads)."""
    rng = random.Random(kind)
    pool = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(5)]
    n, b, c, chunk = {"split": (150, 1, 2, 3), "chunk1": (24, 2, 3, 1),
                      "whole": (40, 2, 5, 1000), "zero_lanes": (30, 3, 4, 7),
                      "infinity": (45, 2, 4, 5), "repeat": (36, 2, 3, 4),
                      "lanes": (20, 6, 4, 16), "narrow": (4, 24, 6, 3)}[kind]
    lanes = [[pool[rng.randrange(5)] for _ in range(b)] for _ in range(n)]
    scal = [[rng.randrange(bn.R) for _ in range(b)] for _ in range(n)]
    for j in range(n):
        if kind == "zero_lanes":
            scal[j][0] = scal[j][2] = 0
        if kind == "infinity" and j % 3 == 0:
            lanes[j][j % b] = None
        if kind == "repeat":
            lanes[j] = [pool[0]] * b
    return lanes, scal, c, chunk


@pytest.mark.parametrize("kind", ["split", "chunk1", "whole", "zero_lanes", "infinity",
                                  "repeat", "lanes", "narrow"])
def test_pippenger_chunked_buckets_equal_plain_twin_and_oracle(lib_rolled, kind):
    """K6's bucket sums over fixed chunks of all rows' sorted entries and
    the merge of runs split between chunks (stages 3-4), through the whole
    MSM: limb-equal to the plain twin and the oracle, whatever cuts the
    runs; the window sums equal the twin's in affine form."""
    from snark_bn254_verifier_tpu_torch.ops import curve as C
    from snark_bn254_verifier_tpu_torch.ops import msm as M

    lanes, scal, c, chunk = chunk_case(kind)
    P, sc = msm_tensors(lanes, scal)
    got, wsum, _, _ = host_pippenger(lib_rolled, P, sc, c, chunk)
    assert_msm_exact(got, P, sc, c, lanes, scal)
    affine = [C.to_affine(M.G1, M.from_words(ws)) for ws in (wsum, M.window_sums_plain(P, sc, c))]
    assert all(torch.equal(g, w) for g, w in zip(*affine))


@pytest.mark.parametrize("k", [1, 3])
def test_pippenger_combine_sums_k_sets_of_window_sums(lib, lib_rolled, k):
    """K6's combine (stage 6, the unrolled Montgomery product, its unit's
    form) on k sets of window sums, the host stages' for set 0 and the
    plain twin's for the rest (another form of the same Jacobian points):
    the affine sum of all k MSMs, limb-equal to combine_plain and the
    oracle."""
    from snark_bn254_verifier_tpu_torch.ops import msm as M

    c, b, n = 4, 5, 9
    sets = [msm_edge_lanes(random.Random(99 + i), n, b) for i in range(k)]
    tensors = [msm_tensors(*s) for s in sets]
    wsums = [host_pippenger(lib_rolled, P, sc, c, 5)[1] for P, sc in tensors[:1]]
    wsums += [M.window_sums_plain(P, sc, c) for P, sc in tensors[1:]]
    wsums = c_tensor(torch.stack(wsums))
    ox = torch.empty((16, b), dtype=torch.int32)
    oy, oinf = torch.empty_like(ox), torch.empty(b, dtype=torch.bool)
    assert lib.host_pip_combine(ptr(wsums), k, c, ptr(ox), ptr(oy), ptr(oinf), b) == 0
    want = M.combine_plain(wsums, c)
    assert torch.equal(ox, want[0]) and torch.equal(oy, want[1]) and torch.equal(oinf, want[2])
    xs, ys = unpack_fq(ox.numpy()), unpack_fq(oy.numpy())
    union = oracle_msm_lanes([row for lanes, _ in sets for row in lanes],
                             [row for _, scal in sets for row in scal])
    assert [None if oinf[i] else (xs[i], ys[i]) for i in range(b)] == union


def host_plonk_lanes(lib, raw, pub, valid, lvk, reverse=0):
    """K7a then K7b (csrc/plonk.cuh) block by block on the host build (with
    ``reverse`` each stage's threads last to first): K7a's outputs and
    K7b's scalars over a seeded digest a lane (lane 0's at infinity) and
    seeded randomisers, with those inputs."""
    from snark_bn254_verifier_tpu_torch.ops import plonk_lanes as PL

    b, m = raw.shape[0], lvk.nb + 9
    words = torch.as_tensor(lvk.blob().view(np.int32))
    ok = torch.zeros(b, dtype=torch.bool)
    zeta = torch.zeros((16, b), dtype=torch.int32)
    px, py = torch.zeros((m, 16, b), dtype=torch.int32), torch.zeros((m, 16, b), dtype=torch.int32)
    pinf = torch.zeros((m, b), dtype=torch.bool)
    lin = torch.zeros((lvk.nb + 10, 16, b), dtype=torch.int32)
    assert lib.host_plonk_lanes_a_ordered(ptr(raw), lvk.proof_len, ptr(pub), ptr(valid),
                                          ptr(words), ptr(ok), ptr(zeta), ptr(px), ptr(py),
                                          ptr(pinf), ptr(lin), b, reverse) == 0
    rng = random.Random(9)
    digests = [None] + [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(b - 1)]
    dx, dy, dinf = (c_tensor(a) for a in pack_g1(digests))
    rand = c_tensor(pack_fr_columns([[rng.randrange(1, bn.R)] for _ in range(b)], 1, b)[0])
    sc = torch.zeros((lvk.nb + 12, 16, b), dtype=torch.int32)
    assert lib.host_plonk_lanes_b_ordered(ptr(raw), lvk.proof_len, ptr(ok), ptr(zeta),
                                          ptr(rand), ptr(dx), ptr(dy), ptr(dinf), ptr(words),
                                          ptr(sc), b, reverse) == 0
    return (ok, zeta, (px, py, pinf), lin), ((dx, dy, dinf), rand, sc)


def plonk_host_lanes_of_every_kind(n_bsb22=1):
    """A lane of every kind of fixtures/plonk_lanes.py and two good ones,
    packed as the verifier packs them: (raw, pub, valid, lvk, bad,
    expected)."""
    from snark_bn254_verifier_tpu_torch.fixtures.plonk_lanes import KINDS, plonk_batch_lanes
    from snark_bn254_verifier_tpu_torch.ops import plonk_lanes as PL
    from snark_bn254_verifier_tpu_torch.utils import serialization as ser

    bad = {1 + k: kind for k, kind in enumerate(KINDS)}
    vec, proofs, inputs, expected = plonk_batch_lanes(len(KINDS) + 2, bad, n_bsb22)
    lvk = PL.LanesVk(ser.load_plonk_verifying_key_from_bytes(vec.vk))
    raw, valid = PL.pack_proofs(proofs, lvk)
    counted = np.array([len(ins) == lvk.nb_pub for ins in inputs])
    pub = pack_fr_columns([ins if c else None for ins, c in zip(inputs, counted)],
                           lvk.nb_pub, len(proofs))
    raw, pub, valid = c_tensor(raw), c_tensor(pub), c_tensor(valid & counted)
    return raw, pub, valid, lvk, bad, expected


def assert_host_plonk_lanes_equal_twins(lib, lanes, reverse):
    from snark_bn254_verifier_tpu_torch.ops import plonk_lanes as PL

    raw, pub, valid, lvk, bad, expected = lanes
    (ok, zeta, pts, lin), (digest, rand, sc) = host_plonk_lanes(lib, raw, pub, valid, lvk,
                                                                reverse)
    t_ok, t_zeta, t_pts, t_lin = PL.plonk_lanes_a_plain(raw, pub, valid, lvk)
    assert torch.equal(ok, t_ok) and torch.equal(zeta, t_zeta) and torch.equal(lin, t_lin)
    assert all(torch.equal(a, b) for a, b in zip(pts, t_pts))
    doubled = [i for i, k in bad.items() if k in ("opening_doubled", "shifted_doubled")]
    assert ok.tolist() == [e or i in doubled for i, e in enumerate(expected)]
    assert torch.equal(sc, PL.plonk_lanes_b_plain(raw, ok, zeta, rand, digest, lvk))
    assert sc[:, :, ok].any() and not sc[:, :, ~ok].any()


def test_plonk_lanes_host_build_equals_plain_twins(lib):
    """K7a and K7b's lane bodies built by g++, on a lane of every kind of
    fixtures/plonk_lanes.py (the new non-canonical and off-curve kinds
    among them): every output limb for limb equal to their plain twins
    (which tests/test_torch_plonk_lanes.py holds against the JAX
    package's host passes), the valid bits the expected verdicts but the
    doubled openings', which fail in the pairing."""
    assert_host_plonk_lanes_equal_twins(lib, plonk_host_lanes_of_every_kind(), 0)


def test_plonk_lanes_host_build_in_reverse_thread_order(lib):
    """The same lanes with each stage's threads run last to first (the
    shared memory poisoned before each block, as in every order): a stage
    that read a slot another warp writes in the same stage, a race on the
    card, would read the poison or a stale value in one of the two
    orders; both equal the twins."""
    assert_host_plonk_lanes_equal_twins(lib, plonk_host_lanes_of_every_kind(), 1)


@pytest.mark.parametrize("n_bsb22", [2, 3])
def test_plonk_lanes_host_build_at_more_commitments(lib, n_bsb22):
    """A VK of 2 and 3 BSB22 commitments (longer rows, more slots, more
    hashes: past 48 KB of shared memory on the card, K7b from 2, K7a
    from 3), a lane of every kind, both thread orders, equal to the
    twins."""
    lanes = plonk_host_lanes_of_every_kind(n_bsb22)
    assert lanes[3].nb == n_bsb22
    for reverse in (0, 1):
        assert_host_plonk_lanes_equal_twins(lib, lanes, reverse)


def test_plonk_shared_memory_ceiling_is_the_wrappers(lib):
    """K7's dynamic shared bytes a block (the host build of plonk.cuh's
    layout): 45,056 (K7a) and 46,464 (K7b) at one commitment, above
    48 KB from 2 (K7b) and 3 (K7a), so the entry raises the kernel's limit
    there; the most commitments that fit 227 KB (232,448 B) is 37, set by
    K7b, and the wrappers refuse more on the card."""
    from types import SimpleNamespace

    from snark_bn254_verifier_tpu_torch.ops import plonk_cuda as PCU
    from snark_bn254_verifier_tpu_torch.ops.plonk_lanes import proof_bytes

    def smem(nb, lanes_a):
        return lib.host_plonk_smem_bytes(proof_bytes(nb), nb, int(lanes_a))

    assert (smem(1, True), smem(1, False)) == (45_056, 46_464)
    assert smem(2, True) <= 48 * 1024 < smem(2, False) and smem(3, True) > 48 * 1024
    assert lib.host_plonk_max_nb() == PCU.K7_MAX_NB == 37
    assert max(smem(37, True), smem(37, False)) <= 232_448 < smem(38, False)
    PCU.check_nb(SimpleNamespace(nb=37))
    with pytest.raises(ValueError, match="at most 37 BSB22 commitments"):
        PCU.check_nb(SimpleNamespace(nb=38))

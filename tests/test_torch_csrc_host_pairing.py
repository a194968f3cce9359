"""K3, K4 and K5 (team.cuh) built for the host (csrc/host_check.cc, each
thread of a block a fiber), each with the form of the Montgomery product
its unit runs on the card, against the oracle and the plain twins:
final_exp(miller_mixed) over g2_lines' rows, K3 with infinite pairs and
fixed-only, K4 on arbitrary lanes, K5's Miller-product team on infinite
pairs and ragged blocks. Skips where no host C++ compiler is installed."""

import random

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu_torch.models.packing import (
    pack_fq12,
    pack_g1,
    pack_g2,
    pair_major,
    unpack_fq12,
)
from snark_bn254_verifier_tpu_torch.ops import lines as LN
from torch_host_build import (  # noqa: F401 (one_torch_thread: autouse)
    c_tensor,
    host_miller_mixed,
    lib,
    lib_rolled,
    one_torch_thread,
    ptr,
)


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

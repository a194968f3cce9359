"""K2's MSM team and the fixed-base MSM's team (msm.cuh, msm_fixed.cuh)
built for the host (csrc/host_check.cc, each thread of a block a fiber),
with the rolled Montgomery product their units run on the card, against
the oracle and the plain twins: single lanes, point groups, edge lanes
and ragged blocks. Skips where no host C++ compiler is installed."""

import random

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu_torch.models.packing import pack_g1, unpack_fq
from snark_bn254_verifier_tpu_torch.ops.limbs import FR
from torch_host_build import (  # noqa: F401 (one_torch_thread: autouse)
    c_tensor,
    lib_rolled,
    msm_edge_lanes,
    one_torch_thread,
    ptr,
)


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

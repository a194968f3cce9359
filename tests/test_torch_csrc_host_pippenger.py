"""K6's six stages (pippenger.cuh) built for the host (csrc/host_check.cc:
the sort and the reduction a block at a time, each thread a fiber; the
per-thread stages thread by thread), against the plain twins and the
oracle: the counting sort, the chunked bucket sums and their merge, the
window sums, the combine of k sets, and the whole MSM. Skips where no
host C++ compiler is installed."""

import ctypes
import random

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu_torch.models.packing import pack_g1, pair_major, unpack_fq
from snark_bn254_verifier_tpu_torch.ops.limbs import FR
from torch_host_build import (  # noqa: F401 (one_torch_thread: autouse)
    c_tensor,
    lib,
    lib_rolled,
    msm_edge_lanes,
    one_torch_thread,
    ptr,
)


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

"""The port's large MSM (ops/msm.py): Pippenger's plain twin, the twin of
kernel K6, against the JAX package's oracle (oracle/bn254.py::g1_msm,
which imports no JAX), the port's oracle and K2's plain twin, over lanes
with zero scalars, points at infinity, one point repeated (P + P inside a
bucket) and all-zero scalars; ``_digits`` against the JAX package's;
msm_best's switch by points and lanes; TorchBackend.msm through it.

Slow: the JAX package's msm_pippenger_jit on the same points."""

import random

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.oracle import bn254 as jax_bn
from snark_bn254_verifier_tpu_torch import TorchBackend
from snark_bn254_verifier_tpu_torch.models.packing import pack_g1, pair_major, unpack_g1
from snark_bn254_verifier_tpu_torch.ops import curve as C
from snark_bn254_verifier_tpu_torch.ops import msm as M
from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC
from snark_bn254_verifier_tpu_torch.ops.limbs import FR
from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain twins' tensors are a few lanes wide, too narrow for torch's
    threads; one thread keeps parallel test workers off each other's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def msm_lanes(seed, n, b):
    """n points per lane over b lanes, with numpy's default_rng(seed):
    lane 0 random points and scalars, a tenth of each at infinity or zero;
    lane 1 one point throughout (every bucket adds P + P); lane 2 all
    scalars zero (the sum is infinity); more lanes as lane 0. Returns
    (points[j][lane] or None, scalars[j][lane], tensors)."""
    rng = np.random.default_rng(seed)
    prng = random.Random(seed)
    pool = [bn.g1_mul(bn.G1_GEN, prng.randrange(1, bn.R)) for _ in range(6)]
    pts = [[pool[i] for i in rng.integers(0, len(pool), size=b)] for _ in range(n)]
    scs = [[int.from_bytes(rng.bytes(32), "little") % bn.R for _ in range(b)] for _ in range(n)]
    for j in range(n):
        for lane in [0] + list(range(3, b)):
            if rng.random() < 0.1:
                pts[j][lane] = None
            if rng.random() < 0.1:
                scs[j][lane] = 0
        if b > 1:
            pts[j][1] = pool[0]
        if b > 2:
            scs[j][2] = 0
    points = tuple(torch.as_tensor(a) for a in pair_major(pack_g1, pts))
    scalars = torch.as_tensor(np.stack([FR.pack(row, mont=False) for row in scs]))
    return pts, scs, (points, scalars)


def oracle_sums(oracle, pts, scs, b):
    """``oracle.g1_msm`` per lane, over the lane's distinct points with
    their scalars summed mod r (the same sum; the lanes draw from a pool
    of six points, and each oracle multiplication takes milliseconds)."""
    out = []
    for lane in range(b):
        agg = {}
        for p, s in zip(pts, scs):
            if p[lane] is not None:
                agg[p[lane]] = (agg.get(p[lane], 0) + s[lane]) % bn.R
        out.append(oracle.g1_msm(list(agg), list(agg.values())))
    return out


@pytest.mark.parametrize("n,c", [(64, 8), (130, 4), (130, 8), (64, 4)])
def test_pippenger_twin_equals_both_oracles(n, c):
    """At (64, 8), the threshold, also limb for limb equal to K2's twin
    (both are affine)."""
    pts, scs, (points, scalars) = msm_lanes(70 + n + c, n, 3)
    out = M.pippenger_plain(points, scalars, c)
    got = unpack_g1(*out)
    assert got == oracle_sums(jax_bn, pts, scs, 3) == oracle_sums(bn, pts, scs, 3)
    assert got[2] is None
    if (n, c) == (64, 8):
        assert all(torch.equal(g, w) for g, w in zip(out, C.msm_affine(points, scalars)))


@pytest.mark.parametrize("c", [0, 17])
def test_digits_reject_window_widths_outside_1_to_16(c):
    with pytest.raises(ValueError):
        M._digits(torch.zeros((1, 16, 1), dtype=torch.int32), c)
    _, _, (points, scalars) = msm_lanes(76, 2, 1)
    with pytest.raises(ValueError):
        M.msm_pippenger(points, scalars, c)


@pytest.mark.parametrize("c", [1, 5, 8, 16])
def test_digits_equal_jax(c):
    """The JAX package's _digits takes one MSM's (N, 16) limbs; the port's
    takes (N, 16, B)."""
    from snark_bn254_verifier_tpu.ops import msm as jax_msm

    rng = np.random.default_rng(77 + c)
    scalars = FR.pack([int.from_bytes(rng.bytes(32), "little") for _ in range(9)] + [bn.R - 1],
                      mont=False).T  # (N, 16)
    want = np.asarray(jax_msm._digits(scalars.astype(np.uint32), c, M.windows(c)))
    got = M._digits(torch.as_tensor(scalars)[..., None], c)[..., 0].numpy()
    assert np.array_equal(got, want)


def test_bucket_order_runs_hold_their_digit():
    _, _, (points, scalars) = msm_lanes(78, 40, 2)
    digits, order, starts = M.bucket_order(points[2], scalars, 4)
    raw = M._digits(scalars, 4).masked_fill(points[2].unsqueeze(0), 0)  # (W, N, B)
    for lane in range(2):
        for win in (0, 30, 63):
            for j in range(16):
                lo, hi = starts[lane, win, j], starts[lane, win, j + 1]
                idx = order[lane, win, lo:hi]
                assert (raw[win, idx, lane] == j).all() and (digits[lane, win, lo:hi] == j).all()
            assert starts[lane, win, 16] == 40


@pytest.mark.parametrize("n,b,kernel", [
    (15, 1, "msm_affine"), (16, 1, "msm_pippenger"),         # B = 1: from 16 points
    (16, 32, "msm_pippenger"), (16, 65, "msm_affine"),       # B = 32: from 16 points
    (64, 1024, "msm_affine"), (255, 1024, "msm_affine"),     # B = 1024: from 256
    (256, 1024, "msm_pippenger"), (15, 32, "msm_affine"),
])
def test_msm_best_switches_at_the_threshold(monkeypatch, n, b, kernel):
    """The switch measured on the card (ops/msm.py::use_pippenger): K6 from
    16 points where there are no more than 4 lanes a point."""
    calls = []
    for name in ("msm_affine", "msm_pippenger"):
        monkeypatch.setattr(PC, name, lambda *a, name=name: calls.append(name))
    points = tuple(torch.zeros((n, 16, b), dtype=torch.int32) for _ in range(2))
    M.msm_best(points + (torch.ones((n, b), dtype=torch.bool),),
               torch.zeros((n, 16, b), dtype=torch.int32))
    assert calls == [kernel] and M.PIPPENGER_THRESHOLD == 16


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    _, _, (points, scalars) = msm_lanes(79, 5, 1)
    before = PC.msm_pippenger.launches
    got = M.msm_pippenger_batched(points, scalars, 4)
    assert PC.msm_pippenger.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, M.pippenger_plain(points, scalars, 4)))


def test_torch_backend_msm_runs_pippenger_from_64_points(monkeypatch):
    """TorchBackend.msm at 80 points: through msm_best to K6's wrapper
    (its twin on the CPU), equal to the oracle."""
    rng = random.Random(80)
    pts = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(8)] * 10
    scs = [rng.randrange(bn.R) for _ in range(80)]
    seen, real = [], PC.msm_pippenger
    monkeypatch.setattr(PC, "msm_pippenger", lambda *a: seen.append(len(a[0][0])) or real(*a))
    assert TorchBackend("cpu").msm(pts, scs) == oracle_sums(bn, [[p] for p in pts],
                                                            [[s] for s in scs], 1)[0]
    assert seen == [80]


@pytest.mark.slow  # the JAX package's Pippenger compiles for minutes on XLA:CPU
def test_pippenger_twin_equals_jax_msm_pippenger():
    import jax

    from snark_bn254_verifier_tpu.models.jax_backend import unpack_g1_jacobian
    from snark_bn254_verifier_tpu.ops import msm as jax_msm

    pts, scs, (points, scalars) = msm_lanes(81, 64, 1)
    jax_points = tuple(np.asarray(t[..., 0]).astype(np.uint32) if t.dtype != torch.bool
                       else np.asarray(t[..., 0]) for t in points)
    out = jax_msm.msm_pippenger_jit(jax_points, np.asarray(scalars[..., 0]).astype(np.uint32))
    want = unpack_g1_jacobian(jax.tree_util.tree_map(lambda a: a[:, None], out))[0]
    assert unpack_g1(*M.pippenger_plain(points, scalars))[0] == want

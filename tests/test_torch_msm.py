"""The port's large MSM (ops/msm.py): Pippenger's plain twin, the twin of
kernel K6, against the JAX package's oracle (oracle/bn254.py::g1_msm,
which imports no JAX), the port's oracle and K2's plain twin, over lanes
with zero scalars, points at infinity, one point repeated (P + P inside a
bucket) and all-zero scalars; ``_digits`` against the JAX package's;
msm_best's switch by points and lanes; TorchBackend.msm through it. The
fixed-base MSM: its window table's plain twin against the oracle, the
plain twin of kernel msm_fixed against K2's and the oracle on the edge
lanes of fixtures/msm_lanes.py::fixed_base_lanes, and the Groth16 facade
on it against the oracle backend.

Slow: the JAX package's msm_pippenger_jit on the same points."""

import random

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.oracle import bn254 as jax_bn
from snark_bn254_verifier_tpu_torch import TorchBackend
from snark_bn254_verifier_tpu_torch.fixtures.msm_lanes import FIXED_BASE_EDGES, fixed_base_lanes
from snark_bn254_verifier_tpu_torch.models.packing import pack_g1, pair_major, unpack_g1
from snark_bn254_verifier_tpu_torch.ops import curve as C
from snark_bn254_verifier_tpu_torch.ops import msm as M
from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC
from snark_bn254_verifier_tpu_torch.ops.limbs import FQ, FR
from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn
from torch_host_build import one_torch_thread  # noqa: F401 (autouse)


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


FIXED_LANES = list(FIXED_BASE_EDGES) + ["random", "random_2"]  # lane by lane
FIXED_B = len(FIXED_LANES)


@pytest.fixture(scope="module")
def fixed():
    """Three fixed points (the last at infinity), their window table by
    the plain twin, the lanes' scalars, the fixed-base twin's sums and
    K2's twin's on the same lanes."""
    pts, scs, logs = fixed_base_lanes(3, FIXED_B, 90)
    table = M.fixed_table_plain(tuple(torch.as_tensor(a) for a in pack_g1(pts)))
    scalars = torch.as_tensor(np.stack([FR.pack(row, mont=False) for row in scs]))
    lanes = tuple(torch.as_tensor(a) for a in pair_major(pack_g1, [[p] * FIXED_B for p in pts]))
    return {"pts": pts, "scs": scs, "logs": logs, "table": table,
            "got": M.msm_fixed_plain(table, scalars), "k2": C.msm_affine(lanes, scalars),
            "jax": oracle_sums(jax_bn, [[p] * FIXED_B for p in pts], scs, FIXED_B)}


@pytest.mark.parametrize("w,d", [(0, 1), (0, 255), (1, 2), (7, 128), (30, 77), (31, 1),
                                 (31, 63), (31, 255)])
def test_fixed_table_entries_equal_the_oracle(fixed, w, d):
    """Entry d of window w of each point is d * 2^(8 w) * P, affine, in
    32-bit words (x, then y), by both oracles; the point at infinity's
    entries are zero."""
    table = fixed["table"]
    assert table.shape == (3, 32, 255, M.ENTRY_WORDS) and M.FIXED_WINDOW == 8
    x, y = M.from_words(table[:, w, d - 1])
    for j, p in enumerate(fixed["pts"]):
        want = bn.g1_mul(p, d << (8 * w)) if p is not None else None
        assert want == (jax_bn.g1_mul(p, d << (8 * w)) if p is not None else None)
        got = (FQ.unpack(x[:, j].numpy())[0], FQ.unpack(y[:, j].numpy())[0])
        assert got == (want if want is not None else (0, 0)), j


@pytest.mark.parametrize("lane", range(FIXED_B), ids=FIXED_LANES)
def test_msm_fixed_twin_equals_k2_twin_and_oracle(fixed, lane):
    """The fixed-base twin on one lane of each edge: limb-equal to K2's
    twin on the same points and scalars, and equal to the MSM of both
    oracles and to (sum_j s_j k_j) G."""
    got, k2 = fixed["got"], fixed["k2"]
    assert all(torch.equal(g[..., lane], w[..., lane]) for g, w in zip(got, k2))
    want = bn.g1_mul(bn.G1_GEN, sum(s[lane] * k for s, k in zip(fixed["scs"], fixed["logs"]))
                     % bn.R)
    assert unpack_g1(*(t[..., lane:lane + 1] for t in got))[0] == want == fixed["jax"][lane]
    assert want == bn.g1_msm(fixed["pts"][:2], [s[lane] for s in fixed["scs"][:2]])
    assert (want is None) == (FIXED_LANES[lane] in ("zero", "cancels"))


def test_msm_fixed_on_cpu_tensors_takes_the_twin_and_counts_no_launch(fixed):
    scalars = torch.as_tensor(np.stack([FR.pack(row, mont=False) for row in fixed["scs"]]))
    before = PC.msm_fixed.launches
    got = PC.msm_fixed(fixed["table"], scalars)
    assert PC.msm_fixed.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, fixed["got"]))
    with pytest.raises(ValueError):
        PC.msm_fixed(fixed["table"][:, :, :100], scalars)


@pytest.mark.parametrize("n", [0, M.FIXED_MAX_POINTS + 1, 200])
def test_no_window_table_outside_the_size_rule(n):
    """No points, or more than FIXED_MAX_POINTS (a VK of many inputs,
    whose tables would pass a third of the L2), get no table: the
    backend's MSM serves them. At most FIXED_MAX_POINTS do."""
    assert not M.use_fixed_table(n) and M.use_fixed_table(M.FIXED_MAX_POINTS)
    assert TorchBackend.instance("cpu").fixed_base_table([bn.G1_GEN] * n) is None


@pytest.fixture(scope="module")
def g16_prepared():
    """A Groth16 vector and its VK prepared on the torch CPU backend (with
    the window table of k[1:]) and on the oracle backend (with none)."""
    from snark_bn254_verifier_tpu_torch.fixtures.gen import gen_groth16_vector
    from snark_bn254_verifier_tpu_torch.models.backend import get_backend
    from snark_bn254_verifier_tpu_torch.models.groth16 import PreparedVerifyingKey
    from snark_bn254_verifier_tpu_torch.utils import serialization as ser

    vec = gen_groth16_vector(3)
    vk = ser.load_groth16_verifying_key_from_bytes(vec.vk)
    torch_cpu, oracle = TorchBackend.instance("cpu"), get_backend("oracle")
    return vec, vk, {b: PreparedVerifyingKey.from_vk(vk, b) for b in (torch_cpu, oracle)}


@pytest.mark.parametrize("case", ["good", "wrong input value", "wrong input count"])
def test_groth16_facade_on_the_table_gives_the_oracle_backends_outcome(g16_prepared, case):
    """verify_groth16 on TorchBackend("cpu") with its prepared VK, whose
    prepared input goes through the fixed-base MSM, against the same
    protocol code on the oracle backend (plain MSM): the same verdict or
    the same error."""
    from snark_bn254_verifier_tpu_torch.models.groth16 import verify_groth16
    from snark_bn254_verifier_tpu_torch.utils import errors
    from snark_bn254_verifier_tpu_torch.utils import serialization as ser

    vec, vk, prepared = g16_prepared
    ins = list(vec.public_inputs)
    ins = {"good": ins, "wrong input value": [ins[0] + 1] + ins[1:],
           "wrong input count": ins[:-1]}[case]
    proof = ser.load_groth16_proof_from_bytes(vec.proof)
    outcomes = {}
    for backend, prep in prepared.items():
        assert (prep.k_table(backend) is None) == (backend.name == "oracle")
        try:
            outcomes[backend.name] = verify_groth16(vk, proof, ins, backend=backend,
                                                    prepared=prep)
        except errors.VerifierError as e:
            outcomes[backend.name] = type(e).__name__
    assert outcomes["torch"] == outcomes["oracle"] == {
        "good": True, "wrong input value": False,
        "wrong input count": "PrepareInputsFailedError"}[case]


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

"""PyTorch port, the PlonK batch: PlonkBatchVerifier(vk, device="cpu") (the
kernels' plain twins) against the JAX package's PlonkBatchVerifier
(snark_bn254_verifier_tpu/parallel/batch.py:430-733) and against per-lane
verify_plonk on the oracle backend, on gen_plonk_vector(0) lanes with bad
lanes of every kind (fixtures/plonk_lanes.py).

The lane pass (kernel K7a's plain twin, ops/plonk_lanes.py) is compared
with the JAX verifier's host methods directly (pure Python, no XLA
compile). Slow: the JAX verifier's whole batch, same rng, same bools and
the same phase-A digests."""

import random

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.parallel import batch as jax_batch
from snark_bn254_verifier_tpu.utils import errors as jax_errors
from snark_bn254_verifier_tpu.utils import serialization as jax_ser
from snark_bn254_verifier_tpu_torch import PlonkBatchVerifier
from snark_bn254_verifier_tpu_torch.fixtures.plonk_lanes import KINDS, plonk_batch_lanes
from snark_bn254_verifier_tpu_torch.models.packing import pack_fr_columns
from snark_bn254_verifier_tpu_torch.models.plonk import verify_plonk
from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC
from snark_bn254_verifier_tpu_torch.ops import plonk_lanes as PL
from snark_bn254_verifier_tpu_torch.ops.limbs import FQ, FR
from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn
from snark_bn254_verifier_tpu_torch.utils import errors
from snark_bn254_verifier_tpu_torch.utils import serialization as ser
from torch_host_build import one_torch_thread  # noqa: F401 (autouse)

# lanes 0 and 8 good; around them every kind the device or the host
# rejects but the wrong input count (which test_all_bad_lanes_stay_on_the_host
# and the on-card batch take)
BAD = {1: "wrong_value", 2: "claimed0", 3: "truncated", 4: "other_statement",
       5: "opening_doubled", 6: "shifted_doubled", 7: "extra_claimed", 9: "noncanonical_x",
       10: "claimed_ge_r", 11: "off_curve"}


def seeded_rng(seed):
    rng = random.Random(seed)
    return lambda: rng.randrange(1, bn.R)


@pytest.fixture(scope="module")
def lanes():
    return plonk_batch_lanes(12, BAD)


@pytest.fixture(scope="module")
def cpu_run(lanes):
    vec, proofs, inputs, _ = lanes
    ver = PlonkBatchVerifier(vec.vk, device="cpu")
    return ver.verify_batch(proofs, inputs, rng=seeded_rng(7)), ver.last_stats


def oracle_bool(vk, proof, inputs):
    try:
        return verify_plonk(vk, ser.load_plonk_proof_from_bytes(proof), inputs,
                            backend="oracle")
    except errors.VerifierError:
        return False


def lane_sums(values, k):
    """K7a's L1 and PI on its twin (ops/plonk_lanes.py::lagrange_sums, which
    plonk_lanes_a_plain runs): the denominators ``values``, k a lane over
    len(values) / k lanes, the lane's first as L1's and the rest with
    numerators 1, 2, ..., zs = 1. Returns (L1 a lane, PI a lane, a zero
    denominator a lane)."""
    b = len(values) // k

    def column(vals):
        return torch.as_tensor(FR.pack(vals), dtype=torch.int64)

    d0 = column([values[lane * k] for lane in range(b)])
    terms = [(column([i] * b), column([values[lane * k + i] for lane in range(b)]))
             for i in range(1, k)]
    l1, pi, zero = PL.lagrange_sums(column([1] * b), d0, terms)
    return FR.unpack(l1.numpy()), FR.unpack(pi.numpy()), zero.tolist()


@pytest.mark.parametrize("zeros", [(), (0,), (3, 17), (0, 1, 2, 3)])
def test_batch_inv_mod_r_equals_jax(zeros):
    """K7a's one inversion a lane (L1 and PI summed as one fraction,
    lagrange_sums) against the JAX package's batch inversion: 24
    denominators, 4 a lane over 6 lanes; a zero denominator masks its
    lane alone."""
    rng = random.Random(len(zeros))
    values = [rng.randrange(1, 2 * bn.R) for _ in range(24)]
    for k, i in enumerate(zeros):
        values[i] = k * bn.R  # zero mod r
    l1, pi, zero = lane_sums(values, 4)
    invs = jax_batch._batch_inv_mod_r(values)
    for lane in range(6):
        lane_invs = invs[4 * lane:4 * lane + 4]
        assert zero[lane] == any(v is None for v in lane_invs)
        if not zero[lane]:
            assert l1[lane] == lane_invs[0]
            assert pi[lane] == sum(i * v for i, v in enumerate(lane_invs)) % bn.R
    assert sum(zero) == len({i // 4 for i in zeros})


def test_batch_inv_mod_r_empty():
    """No Lagrange term: PI is zero and L1 the one inverse, as the JAX
    inversion of nothing is nothing."""
    assert jax_batch._batch_inv_mod_r([]) == []
    assert lane_sums([5, 7], 1) == ([pow(5, -1, bn.R), pow(7, -1, bn.R)], [0, 0], [False] * 2)
    assert lane_sums([5, 0], 1)[2] == [False, True]


def jax_lane(verifier, proof_bytes, inputs):
    """(challenges, finish) of one lane by the JAX verifier's host passes,
    each the dict or the name of the error it raised."""
    proof = jax_ser.load_plonk_proof_from_bytes(proof_bytes)
    ch = verifier._lane_challenges(proof, inputs)
    invs = jax_batch._batch_inv_mod_r(ch["denoms"])
    try:
        fin = verifier._lane_finish(proof, inputs, ch, invs)
    except jax_errors.VerifierError as e:
        fin = type(e).__name__
    return ch, fin


@pytest.fixture(scope="module")
def lane_pass(lanes):
    """K7a's twin over the batch's lanes, as the verifier runs it."""
    vec, proofs, inputs, _ = lanes
    lvk = PL.LanesVk(ser.load_plonk_verifying_key_from_bytes(vec.vk))
    raw, valid = PL.pack_proofs(proofs, lvk)
    pub = pack_fr_columns(inputs, lvk.nb_pub, len(proofs))
    return PC.plonk_lanes_a(torch.as_tensor(raw), torch.as_tensor(pub),
                            torch.as_tensor(valid), lvk)


# good, opening_doubled (passes both), wrong_value, claimed0 (the early check)
@pytest.mark.parametrize("lane", [0, 5, 1, 2])
def test_host_passes_equal_jax(lanes, lane_pass, lane):
    """The lane pass (K7a's twin) against the JAX verifier's passes: zeta,
    the linearisation scalars and the proof's points where the lane passes
    the early check; a False valid bit and zero outputs where the JAX pass
    raises OpeningPolyMismatchError."""
    vec, proofs, inputs, _ = lanes
    ok, zeta, (px, py, pinf), lin = lane_pass
    ch, fin = jax_lane(jax_batch.PlonkBatchVerifier(vec.vk), proofs[lane], inputs[lane])
    if lane in (0, 5):
        assert ok[lane]
        assert FR.unpack(zeta[:, lane:lane + 1].numpy(), mont=False) == [ch["zeta"]]
        assert FR.unpack(lin[:, :, lane].T.numpy(), mont=False) == fin["lin_scalars"]
        # the proof's points among the linearisation's: the commitment,
        # then z, h0, h1, h2 (K7a's rows 0 .. nb - 1 and nb + 3 .. nb + 6)
        nb = lin.shape[0] - 10
        rows = list(range(nb)) + list(range(nb + 3, nb + 7))
        want = fin["lin_points"][:nb] + fin["lin_points"][nb + 6:]
        got = [(FQ.unpack(px[j, :, lane:lane + 1].numpy())[0],
                FQ.unpack(py[j, :, lane:lane + 1].numpy())[0]) for j in rows]
        assert got == want and not pinf[:, lane].any()
    else:
        assert fin == "OpeningPolyMismatchError"
        assert not ok[lane] and not zeta[:, lane].any() and not lin[:, :, lane].any()
        assert pinf[:, lane].all() and not px[:, :, lane].any()


def test_bool_vector_equals_oracle_verify_plonk(lanes, cpu_run):
    """Per-lane verify_plonk on the oracle backend gives the batch's bools;
    the doubled openings pass every lane check and fall in phase B."""
    vec, proofs, inputs, expected = lanes
    ok, _ = cpu_run
    vk = ser.load_plonk_verifying_key_from_bytes(vec.vk)
    assert ok.dtype == bool
    assert ok.tolist() == [oracle_bool(vk, p, i) for p, i in zip(proofs, inputs)] == expected


def test_last_stats(cpu_run):
    _, stats = cpu_run
    assert stats.protocol == "plonk" and stats.batch_size == 12
    assert stats.n_valid == 2 and stats.pairings_per_proof == 2
    assert stats.extra["device"] == "cpu" and stats.extra["packer"] in ("native", "bytes")
    assert stats.extra["host_s"] > 0
    assert set(stats.extra["stage_ms"]) == {
        "parse_ms", "pack_ms", "upload_ms", "lanes_a_ms", "msm_a_ms", "lanes_b_ms",
        "msm_b_ms", "miller_ms", "final_exp_ms", "compare_ms"}


def test_all_bad_lanes_stay_on_the_host():
    """A batch whose every lane fails a host byte check (the input count,
    the proof's length, its count of claimed values) returns all False
    before any device stage; the checks that need arithmetic, claimed0's
    early check among them, are K7a's."""
    vec, proofs, inputs, expected = plonk_batch_lanes(
        4, {0: "wrong_count", 1: "truncated", 2: "extra_claimed", 3: "wrong_count"})
    ver = PlonkBatchVerifier(vec.vk, device="cpu")
    ok = ver.verify_batch(proofs, inputs)
    assert ok.tolist() == expected == [False] * 4
    assert set(ver.last_stats.extra["stage_ms"]) == {"parse_ms"}
    assert ver.last_stats.n_valid == 0


def test_every_kind_of_bad_lane_is_covered():
    assert set(BAD.values()) | {"wrong_count"} == set(KINDS)


def test_cuda_device_without_a_gpu_raises(lanes):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        PlonkBatchVerifier(lanes[0].vk, device="cuda")


@pytest.mark.slow  # the JAX verifier's XLA:CPU MSM and pairing compiles
def test_same_vector_as_jax_batch_verifier(lanes, monkeypatch):
    """The JAX PlonkBatchVerifier and the port on the same 12 lanes with the
    same rng: equal bools, and equal phase-A digests limb for limb (the
    randomisers are drawn in another order, which neither reads)."""
    vec, proofs, inputs, expected = lanes
    seen = {}
    jax_unpack, port_fold = jax_batch._unpack_affine, PC.plonk_lanes_b

    def jax_rec(aff):
        seen["jax"] = [np.asarray(a)[..., :len(proofs)].astype(np.int64) for a in aff]
        return jax_unpack(aff)

    def port_rec(raw, valid, zeta, rand, digest, vk):  # K7b reads phase A's digest
        seen["port"] = [t.numpy().astype(np.int64) for t in digest]
        return port_fold(raw, valid, zeta, rand, digest, vk)

    monkeypatch.setattr(jax_batch, "_unpack_affine", jax_rec)
    monkeypatch.setattr(PC, "plonk_lanes_b", port_rec)
    jax_ok = np.asarray(jax_batch.PlonkBatchVerifier(vec.vk).verify_batch(
        proofs, inputs, rng=seeded_rng(7)))
    ok = PlonkBatchVerifier(vec.vk, device="cpu").verify_batch(proofs, inputs,
                                                               rng=seeded_rng(7))
    assert ok.tolist() == jax_ok.tolist() == expected
    # the JAX verifier's count check lets a surplus claimed value into
    # phase A (it is rejected by the pairing); the port rejects it at parse,
    # as the single-proof path does, so that lane's digest is a dead lane's
    both = [i for i in range(len(proofs)) if BAD.get(i) != "extra_claimed"]
    assert len(both) == len(proofs) - 1
    for a, b in zip(seen["jax"], seen["port"]):
        assert np.array_equal(a[..., both], b[..., both])

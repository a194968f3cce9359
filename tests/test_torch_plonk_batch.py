"""PyTorch port, the PlonK batch: PlonkBatchVerifier(vk, device="cpu") (the
kernels' plain twins) against the JAX package's PlonkBatchVerifier
(snark_bn254_verifier_tpu/parallel/batch.py:430-733) and against per-lane
verify_plonk on the oracle backend, on gen_plonk_vector(0) lanes with bad
lanes of every kind (fixtures/plonk_lanes.py).

The host passes are compared with the JAX methods directly (pure Python,
no XLA compile). Slow: the JAX verifier's whole batch, same rng, same
bools and the same phase-A digests."""

import random

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.parallel import batch as jax_batch
from snark_bn254_verifier_tpu.utils import errors as jax_errors
from snark_bn254_verifier_tpu.utils import serialization as jax_ser
from snark_bn254_verifier_tpu_torch import PlonkBatchVerifier
from snark_bn254_verifier_tpu_torch.fixtures.plonk_lanes import KINDS, plonk_batch_lanes
from snark_bn254_verifier_tpu_torch.models.plonk import verify_plonk
from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn
from snark_bn254_verifier_tpu_torch.parallel import batch
from snark_bn254_verifier_tpu_torch.utils import errors
from snark_bn254_verifier_tpu_torch.utils import serialization as ser

# lanes 0 and 8 good; between them every kind the device or the host
# rejects but the wrong input count (which test_all_bad_lanes_stay_on_the_host
# and the on-card batch take)
BAD = {1: "wrong_value", 2: "claimed0", 3: "truncated", 4: "other_statement",
       5: "opening_doubled", 6: "shifted_doubled", 7: "extra_claimed"}


def seeded_rng(seed):
    rng = random.Random(seed)
    return lambda: rng.randrange(1, bn.R)


@pytest.fixture(scope="module")
def lanes():
    return plonk_batch_lanes(9, BAD)


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


@pytest.mark.parametrize("zeros", [(), (0,), (3, 17), (0, 1, 2, 3)])
def test_batch_inv_mod_r_equals_jax(zeros):
    rng = random.Random(len(zeros))
    values = [rng.randrange(1, 2 * bn.R) for _ in range(24)]
    for k, i in enumerate(zeros):
        values[i] = k * bn.R  # zero mod r
    got = batch._batch_inv_mod_r(values)
    assert got == jax_batch._batch_inv_mod_r(values)
    for v, inv in zip(values, got):
        assert (inv is None) == (v % bn.R == 0)
        assert inv is None or v * inv % bn.R == 1


def test_batch_inv_mod_r_empty():
    assert batch._batch_inv_mod_r([]) == jax_batch._batch_inv_mod_r([]) == []


def lane_passes(pkg_ser, verifier, proof_bytes, inputs):
    """(challenges, finish) of one lane by ``verifier``'s host passes, each
    the dict or the name of the error it raised."""
    proof = pkg_ser.load_plonk_proof_from_bytes(proof_bytes)
    ch = verifier._lane_challenges(proof, inputs)
    invs = batch._batch_inv_mod_r(ch["denoms"])
    try:
        fin = verifier._lane_finish(proof, inputs, ch, invs)
    except (errors.VerifierError, jax_errors.VerifierError) as e:
        fin = type(e).__name__
    return ch, fin


# good, opening_doubled (passes both), wrong_value, claimed0 (the early check)
@pytest.mark.parametrize("lane", [0, 5, 1, 2])
def test_host_passes_equal_jax(lanes, lane):
    """Pass 1 (the challenges, the denominators) and pass 2 (the
    linearisation points and scalars, or the early check's error) key
    for key equal to the JAX verifier's methods."""
    vec, proofs, inputs, _ = lanes
    port = lane_passes(ser, PlonkBatchVerifier(vec.vk, device="cpu"), proofs[lane],
                       inputs[lane])
    ref = lane_passes(jax_ser, jax_batch.PlonkBatchVerifier(vec.vk), proofs[lane], inputs[lane])
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    if lane in (0, 5):
        assert set(port[1]) == {"zeta", "lin_points", "lin_scalars"}
        assert len(port[1]["lin_points"]) == len(port[1]["lin_scalars"]) == 11
    else:
        assert port[1] == "OpeningPolyMismatchError"


def test_bool_vector_equals_oracle_verify_plonk(lanes, cpu_run):
    """Per-lane verify_plonk on the oracle backend gives the batch's bools;
    the doubled openings pass every host check and fall in phase B."""
    vec, proofs, inputs, expected = lanes
    ok, _ = cpu_run
    vk = ser.load_plonk_verifying_key_from_bytes(vec.vk)
    assert ok.dtype == bool
    assert ok.tolist() == [oracle_bool(vk, p, i) for p, i in zip(proofs, inputs)] == expected


def test_last_stats(cpu_run):
    _, stats = cpu_run
    assert stats.protocol == "plonk" and stats.batch_size == 9
    assert stats.n_valid == 2 and stats.pairings_per_proof == 2
    assert stats.extra["device"] == "cpu" and stats.extra["packer"] in ("native", "bytes")
    assert stats.extra["host_s"] > 0
    assert set(stats.extra["stage_ms"]) == {
        "parse_ms", "host_a_ms", "pack_a_ms", "upload_a_ms", "msm_a_ms", "digest_copy_ms",
        "host_b_ms", "pack_b_ms", "upload_b_ms", "msm_b_ms", "miller_ms", "final_exp_ms",
        "compare_ms"}


def test_all_bad_lanes_stay_on_the_host():
    """A batch whose every lane fails a host check returns all False
    before any device stage."""
    vec, proofs, inputs, expected = plonk_batch_lanes(
        4, {0: "wrong_count", 1: "truncated", 2: "claimed0", 3: "extra_claimed"})
    ver = PlonkBatchVerifier(vec.vk, device="cpu")
    ok = ver.verify_batch(proofs, inputs)
    assert ok.tolist() == expected == [False] * 4
    assert set(ver.last_stats.extra["stage_ms"]) == {"parse_ms", "host_a_ms"}
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
    """The JAX PlonkBatchVerifier and the port on the same 9 lanes with the
    same rng: equal bools, and equal phase-A digests limb for limb."""
    vec, proofs, inputs, expected = lanes
    seen = {}
    jax_unpack, port_unpack = jax_batch._unpack_affine, batch.unpack_g1_rows

    def jax_rec(aff):
        seen["jax"] = [np.asarray(a)[..., :len(proofs)].astype(np.int64) for a in aff]
        return jax_unpack(aff)

    def port_rec(rows):  # the digests stacked as (x, y, inf) rows, (33, B)
        seen["port"] = [rows[:16].astype(np.int64), rows[16:32].astype(np.int64),
                        rows[32].astype(np.int64)]
        return port_unpack(rows)

    monkeypatch.setattr(jax_batch, "_unpack_affine", jax_rec)
    monkeypatch.setattr(batch, "unpack_g1_rows", port_rec)
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

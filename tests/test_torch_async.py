"""The port's verify_batch_async on the CPU (the kernels' plain twins), for
Groth16 here and PlonK in tests/test_torch_async_plonk.py: over a stream
of three batches with bad lanes, two in flight, each batch's bools equal
the lanes' oracle verdicts and verify_batch's on the same lanes. On the
CPU the call returns a CPU bool tensor; verify_batch keeps its stage keys.

Slow: the JAX package's verify_batch_async on the same batch."""

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu_torch import Groth16BatchVerifier, PlonkBatchVerifier
from snark_bn254_verifier_tpu_torch.fixtures.groth16_lanes import groth16_batch_lanes
from snark_bn254_verifier_tpu_torch.fixtures.plonk_lanes import plonk_batch_lanes
from torch_host_build import one_torch_thread  # noqa: F401 (autouse)


def rolled(lanes, k):
    """The batch with its lanes rotated by k (its bad lanes move)."""
    vec, proofs, inputs, expected = lanes
    return vec, proofs[k:] + proofs[:k], inputs[k:] + inputs[:k], expected[k:] + expected[:k]


@pytest.fixture(scope="module")
def g16_lanes():
    return groth16_batch_lanes(16)


def test_groth16_stream_two_in_flight(g16_lanes):
    """Batches 1 and 2 in flight; batch 1 read, batch 3 (batch 1's lanes)
    through verify_batch while batch 2 is still out, then batch 2 read."""
    vec = g16_lanes[0]
    b1, b2 = g16_lanes, rolled(g16_lanes, 5)
    ver = Groth16BatchVerifier(vec.vk, device="cpu")
    first = ver.verify_batch_async(b1[1], b1[2])
    second = ver.verify_batch_async(b2[1], b2[2])
    assert isinstance(first, torch.Tensor) and first.device.type == "cpu"
    assert first.dtype == torch.bool and first.tolist() == b1[3]
    sync = ver.verify_batch(b1[1], b1[2])
    assert isinstance(sync, np.ndarray) and sync.tolist() == first.tolist()
    assert second.tolist() == b2[3]
    assert sum(b1[3]) == 11 and b1[3] != b2[3]
    assert set(ver.last_stats.extra["stage_ms"]) == {
        "parse_ms", "pack_ms", "upload_ms", "g2_mask_ms", "msm_ms", "miller_ms",
        "final_exp_ms", "compare_ms"}


def test_staged_uploads_round_trip():
    """The arrays of one upload, packed at aligned offsets into a staging
    buffer (pinned on CUDA; a plain one here), come back as views equal
    to them: int32 limbs of odd sizes, bools, an empty array."""
    from snark_bn254_verifier_tpu_torch.parallel.batch import _staged, _staged_bytes

    rng = np.random.default_rng(5)
    arrays = [rng.integers(0, 1 << 16, size=(3, 16, 5)).astype(np.int32),
              rng.random(7) < 0.5,
              np.zeros((0, 4), np.int32),
              rng.integers(0, 1 << 16, size=(16, 2, 3)).astype(np.int32)[:, 0],
              rng.random((2, 3)) < 0.5]
    arrays = [np.ascontiguousarray(a) for a in arrays]
    staging = torch.zeros(_staged_bytes(arrays) + 8, dtype=torch.uint8)
    out = _staged(arrays, staging, torch.device("cpu"))
    for a, t in zip(arrays, out):
        assert t.dtype == torch.from_numpy(a).dtype and np.array_equal(t.numpy(), a)


def test_plonk_all_bad_batch_skips_the_device_and_returns_a_tensor():
    """Every lane fails a host check: a CPU bool tensor of False, with no
    device stage."""
    vec, proofs, inputs, expected = plonk_batch_lanes(
        3, {0: "wrong_count", 1: "truncated", 2: "extra_claimed"})
    ver = PlonkBatchVerifier(vec.vk, device="cpu")
    ok = ver.verify_batch_async(proofs, inputs)
    assert isinstance(ok, torch.Tensor) and ok.dtype == torch.bool
    assert ok.device.type == "cpu" and ok.tolist() == expected == [False] * 3


@pytest.mark.slow  # the JAX verifier's XLA:CPU pipeline compile
def test_groth16_async_equals_jax_verify_batch_async(g16_lanes):
    from snark_bn254_verifier_tpu.parallel.batch import Groth16BatchVerifier as JaxVerifier

    vec, proofs, inputs, expected = g16_lanes
    jax_ok = np.asarray(JaxVerifier(vec.vk).verify_batch_async(proofs, inputs))
    ok = Groth16BatchVerifier(vec.vk, device="cpu").verify_batch_async(proofs, inputs)
    assert ok.tolist() == jax_ok.tolist() == expected

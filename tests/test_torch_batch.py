"""PyTorch port, the slice end to end: Groth16BatchVerifier(vk, device="cpu")
(the kernels' plain twins) on gen_groth16_vector batches with bad lanes,
per-lane masking as in snark_bn254_verifier_tpu/parallel/batch.py.

Slow: the JAX package's Groth16BatchVerifier gives the same vector."""

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.fixtures.gen import gen_groth16_vector
from snark_bn254_verifier_tpu_torch import Groth16BatchVerifier


@pytest.fixture(scope="module")
def g16():
    return gen_groth16_vector(0)


def bad_lane_batch(vec, other):
    """Eight lanes: a corrupted A (byte 5 flipped, as tests/test_batch.py),
    an off-curve B, a wrong input value, a wrong input count and a proof
    of another statement; all proofs keep one length (native parser)."""
    proofs = [vec.proof] * 8
    inputs = [list(vec.public_inputs) for _ in range(8)]
    bad_a = bytearray(vec.proof)
    bad_a[5] ^= 0xFF
    proofs[1] = bytes(bad_a)
    off_b = bytearray(vec.proof)
    off_b[64 + 127] ^= 1  # last byte of B.y: canonical, off the curve
    proofs[2] = bytes(off_b)
    inputs[3] = [1, 2]
    inputs[4] = [1]
    proofs[5] = other.proof
    expected = [True, False, False, False, False, False, True, True]
    return proofs, inputs, expected


def test_groth16_batch_with_bad_lanes(g16):
    proofs, inputs, expected = bad_lane_batch(g16, gen_groth16_vector(1))
    ver = Groth16BatchVerifier(g16.vk, device="cpu")
    ok = ver.verify_batch(proofs, inputs)
    assert ok.dtype == bool and ok.tolist() == expected
    stats = ver.last_stats
    assert stats.protocol == "groth16" and stats.batch_size == 8
    assert stats.n_valid == 3 and stats.pairings_per_proof == 3
    assert stats.elapsed_s > 0 and stats.extra["parser"] == "native"
    assert set(stats.extra["stage_ms"]) == {
        "host_ms", "g2_mask_ms", "msm_ms", "miller_ms", "final_exp_ms", "compare_ms"}


def test_truncated_proof_sends_batch_to_python_parser(g16):
    """Ragged lengths take the whole batch through the Python parser; the
    truncated lane still comes back False and the others True."""
    proofs = [g16.proof, g16.proof[:200], g16.proof]
    ver = Groth16BatchVerifier(g16.vk, device="cpu")
    ok = ver.verify_batch(proofs, [g16.public_inputs] * 3)
    assert ok.tolist() == [True, False, True]
    assert ver.last_stats.extra["parser"] == "python"


def test_cuda_device_without_a_gpu_raises(g16):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        Groth16BatchVerifier(g16.vk, device="cuda")


@pytest.mark.slow  # the JAX verifier's XLA:CPU pipeline compile
def test_same_vector_as_jax_batch_verifier(g16):
    from snark_bn254_verifier_tpu.parallel.batch import Groth16BatchVerifier as JaxVerifier

    proofs, inputs, expected = bad_lane_batch(g16, gen_groth16_vector(1))
    jax_ok = np.asarray(JaxVerifier(g16.vk).verify_batch(proofs, inputs))
    ok = Groth16BatchVerifier(g16.vk, device="cpu").verify_batch(proofs, inputs)
    assert ok.tolist() == jax_ok.tolist() == expected

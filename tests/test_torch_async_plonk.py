"""The port's PlonkBatchVerifier.verify_batch_async on the CPU (the kernels'
plain twins): over a stream of three batches, two in flight, with a bad
lane of every kind in fixtures/plonk_lanes.py::KINDS, each batch's bools
equal the lanes' oracle verdicts (tests/test_torch_plonk_batch.py holds
those against per-lane verify_plonk) and verify_batch's on the same lanes.

Slow: the JAX package's verify_batch_async on the same batch and rng."""

import random

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu_torch import PlonkBatchVerifier
from snark_bn254_verifier_tpu_torch.fixtures.plonk_lanes import KINDS, plonk_batch_lanes
from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain twins' tensors are a few lanes wide, too narrow for torch's
    threads; one thread keeps parallel test workers off each other's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_rng(seed):
    rng = random.Random(seed)
    return lambda: rng.randrange(1, bn.R)


def lanes_with_every_kind(shift):
    """Ten lanes, lane ``shift`` good, every kind of bad lane after it."""
    return plonk_batch_lanes(10, {(shift + 1 + k) % 10: kind for k, kind in enumerate(KINDS)})


def test_plonk_stream_two_in_flight():
    """Batches 1 and 2 in flight; batch 1 read, batch 3 (batch 1's lanes)
    through verify_batch while batch 2 is still out, then batch 2 read."""
    b1, b2 = lanes_with_every_kind(0), lanes_with_every_kind(5)
    ver = PlonkBatchVerifier(b1[0].vk, device="cpu")
    first = ver.verify_batch_async(b1[1], b1[2], rng=seeded_rng(1))
    second = ver.verify_batch_async(b2[1], b2[2], rng=seeded_rng(2))
    assert isinstance(first, torch.Tensor) and first.device.type == "cpu"
    assert first.tolist() == b1[3]
    sync = ver.verify_batch(b1[1], b1[2], rng=seeded_rng(3))
    assert isinstance(sync, np.ndarray) and sync.tolist() == first.tolist()
    assert second.tolist() == b2[3]
    assert sum(b1[3]) == 2 and b1[3] != b2[3]


@pytest.mark.slow  # the JAX verifier's XLA:CPU MSM and pairing compiles
def test_plonk_async_equals_jax_verify_batch_async():
    from snark_bn254_verifier_tpu.parallel.batch import PlonkBatchVerifier as JaxVerifier

    vec, proofs, inputs, expected = lanes_with_every_kind(0)
    jax_ok = np.asarray(JaxVerifier(vec.vk).verify_batch_async(proofs, inputs, seeded_rng(4)))
    ok = PlonkBatchVerifier(vec.vk, device="cpu").verify_batch_async(proofs, inputs,
                                                                     rng=seeded_rng(4))
    # the JAX verifier lets a surplus claimed value into phase A, where the
    # pairing rejects it; both give False there
    assert ok.tolist() == jax_ok.tolist() == expected

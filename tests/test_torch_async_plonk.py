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
from torch_host_build import one_torch_thread  # noqa: F401 (autouse)


def seeded_rng(seed):
    rng = random.Random(seed)
    return lambda: rng.randrange(1, bn.R)


N = len(KINDS) + 2


def lanes_with_every_kind(shift):
    """Every kind of bad lane and two good lanes, lane ``shift`` good, the
    kinds after it."""
    return plonk_batch_lanes(N, {(shift + 1 + k) % N: kind for k, kind in enumerate(KINDS)})


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


def test_no_host_copy_between_the_phases(monkeypatch):
    """verify_batch_async goes from phase A to phase B through K7b alone
    (its twin here): the stages in order, no digest copy among them, and no
    tensor read back to the host (``.cpu``, ``.numpy``, ``.tolist``,
    ``.item`` raise) before the bools are handed over."""
    vec, proofs, inputs, expected = lanes_with_every_kind(0)
    ver = PlonkBatchVerifier(vec.vk, device="cpu")

    def no_copy(self, *args, **kwargs):
        raise AssertionError("a tensor was copied to the host inside the dispatch")

    with monkeypatch.context() as m:
        for name in ("cpu", "numpy", "tolist", "item"):
            m.setattr(torch.Tensor, name, no_copy)
        ok = ver.verify_batch_async(proofs, inputs, rng=seeded_rng(5))
    assert list(ver.last_stats.extra["stage_ms"]) == [
        "parse_ms", "pack_ms", "upload_ms", "lanes_a_ms", "msm_a_ms", "lanes_b_ms", "msm_b_ms",
        "miller_ms", "final_exp_ms", "compare_ms"]
    assert ok.tolist() == expected


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

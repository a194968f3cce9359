"""PyTorch port, the single-proof API: ``Groth16Verifier.verify`` and
``PlonkVerifier.verify`` with ``device="cpu"`` (the kernels' plain twins
behind a TorchBackend) on the synthetic vectors of fixtures/gen.py. A
good proof verifies, a wrong input value gives False, a wrong input count
raises PrepareInputsFailedError, and malformed or tampered bytes raise the
error class that the oracle backend's run of the same shared protocol code
raises. There is no batch-1 fast path, so each call runs one pipeline.

Slow: the same cases give the same outcomes as the JAX package's facades
with ``backend="jax"`` (XLA:CPU compiles)."""

import hashlib

import pytest

from snark_bn254_verifier_tpu.fixtures.gen import gen_groth16_vector, gen_plonk_vector
from snark_bn254_verifier_tpu.models.groth16 import Groth16Verifier as RefGroth16
from snark_bn254_verifier_tpu.models.plonk import PlonkVerifier as RefPlonk
from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu.utils import errors
from snark_bn254_verifier_tpu.utils import serialization as ser
from snark_bn254_verifier_tpu_torch import Groth16Verifier, PlonkVerifier
from snark_bn254_verifier_tpu_torch.utils import errors as port_errors
from torch_host_build import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def g16():
    return gen_groth16_vector(0)


@pytest.fixture(scope="module")
def plonk():
    return gen_plonk_vector(0)


def outcome(fn):
    try:
        return ("ok", fn())
    except (errors.VerifierError, port_errors.VerifierError) as e:
        # each package raises its own copy of the taxonomy: compare by name
        return ("raises", type(e).__name__)


def tampered_claimed_value(vec):
    """The proof with its first batched claimed value changed by one."""
    cv = ser.load_plonk_proof_from_bytes(vec.proof).batched_proof.claimed_values[0]
    old, new = cv.to_bytes(32, "big"), ((cv + 1) % bn.R).to_bytes(32, "big")
    assert vec.proof.count(old) == 1
    return vec.proof.replace(old, new)


def test_groth16_good_proof_verifies(g16):
    assert Groth16Verifier.verify(g16.proof, g16.vk, g16.public_inputs, device="cpu") is True
    # the cached e(alpha, beta) came from K5 + K4's twins; the window
    # table of k[1:] (2 points, 32 windows of 255 entries) from the table's
    vk, prepared = Groth16Verifier._cache[hashlib.sha256(g16.vk).digest()]
    assert prepared.alpha_beta == bn.pairing(vk.alpha_g1, vk.beta_g2)
    from snark_bn254_verifier_tpu_torch import TorchBackend

    assert prepared.tables[TorchBackend.instance("cpu")].shape == (2, 32, 255, 16)


def test_groth16_wrong_input_value_is_false(g16):
    wrong = [g16.public_inputs[0] + 1] + list(g16.public_inputs[1:])
    assert Groth16Verifier.verify(g16.proof, g16.vk, wrong, device="cpu") is False


def test_groth16_wrong_input_count_raises(g16):
    with pytest.raises(port_errors.PrepareInputsFailedError):
        Groth16Verifier.verify(g16.proof, g16.vk, list(g16.public_inputs[:-1]), device="cpu")


def _malformed(vec, case):
    flipped = bytearray(vec.proof)
    flipped[40] ^= 1
    return {
        "truncated proof": (vec.proof[:100], vec.vk),
        "corrupted proof byte": (bytes(flipped), vec.vk),
        "truncated vk": (vec.proof, vec.vk[:100]),
    }[case]


@pytest.mark.parametrize("case", ["truncated proof", "corrupted proof byte", "truncated vk"])
@pytest.mark.parametrize("proto", ["groth16", "plonk"])
def test_malformed_bytes_raise_the_oracle_error(g16, plonk, proto, case):
    vec, port, ref = (g16, Groth16Verifier, RefGroth16) if proto == "groth16" else (
        plonk, PlonkVerifier, RefPlonk)
    proof, vk = _malformed(vec, case)
    want = outcome(lambda: ref.verify(proof, vk, vec.public_inputs, backend="oracle"))
    assert want[0] == "raises"
    assert outcome(lambda: port.verify(proof, vk, vec.public_inputs, device="cpu")) == want


def test_plonk_good_proof_verifies(plonk):
    assert PlonkVerifier.verify(plonk.proof, plonk.vk, plonk.public_inputs, device="cpu") is True


def test_plonk_tampered_claimed_value_raises_the_oracle_error(plonk):
    proof = tampered_claimed_value(plonk)
    want = outcome(lambda: RefPlonk.verify(proof, plonk.vk, plonk.public_inputs, backend="oracle"))
    assert want == ("raises", "OpeningPolyMismatchError")
    got = outcome(lambda: PlonkVerifier.verify(proof, plonk.vk, plonk.public_inputs, device="cpu"))
    assert got == want


class _Stop(Exception):
    pass


@pytest.mark.parametrize("entry", ["Groth16Verifier.verify", "PlonkVerifier.verify",
                                   "Groth16BatchVerifier", "PlonkBatchVerifier",
                                   "TorchBackend", "init_distributed", "make_mesh"])
def test_entry_points_default_to_the_card(g16, plonk, entry, monkeypatch):
    """Without a device argument every entry point asks for "cuda": the CPU
    runs only when the caller names it. The device resolver is replaced by
    a recorder that stops the call, so nothing runs on either device."""
    from snark_bn254_verifier_tpu_torch import (Groth16BatchVerifier, PlonkBatchVerifier,
                                                TorchBackend)
    from snark_bn254_verifier_tpu_torch.models import torch_backend
    from snark_bn254_verifier_tpu_torch.parallel import batch, sharded

    asked = []

    def recorder(device):
        asked.append(device)
        raise _Stop

    monkeypatch.setattr(batch, "resolve_device", recorder)
    monkeypatch.setattr(torch_backend, "resolve_device", recorder)
    monkeypatch.setattr(sharded, "resolve_device", recorder)
    call = {
        "Groth16Verifier.verify": lambda: Groth16Verifier.verify(g16.proof, g16.vk,
                                                                 g16.public_inputs),
        "PlonkVerifier.verify": lambda: PlonkVerifier.verify(plonk.proof, plonk.vk,
                                                             plonk.public_inputs),
        "Groth16BatchVerifier": lambda: Groth16BatchVerifier(g16.vk),
        "PlonkBatchVerifier": lambda: PlonkBatchVerifier(plonk.vk),
        "TorchBackend": lambda: TorchBackend(),
        "init_distributed": lambda: sharded.init_distributed(),
        "make_mesh": lambda: sharded.make_mesh(),
    }[entry]
    with pytest.raises(_Stop):
        call()
    assert asked == ["cuda"]


@pytest.mark.slow  # the JAX backend's XLA:CPU pairing and MSM compiles
def test_same_outcomes_as_jax_backend(g16, plonk):
    wrong = [g16.public_inputs[0] + 1] + list(g16.public_inputs[1:])
    cases = [
        (Groth16Verifier, RefGroth16, g16.proof, g16.vk, g16.public_inputs),
        (Groth16Verifier, RefGroth16, g16.proof, g16.vk, wrong),
        (PlonkVerifier, RefPlonk, plonk.proof, plonk.vk, plonk.public_inputs),
        (PlonkVerifier, RefPlonk, tampered_claimed_value(plonk), plonk.vk,
         plonk.public_inputs),
    ]
    for port, ref, proof, vk, ins in cases:
        want = outcome(lambda: ref.verify(proof, vk, ins, backend="jax"))
        assert outcome(lambda: port.verify(proof, vk, ins, device="cpu")) == want

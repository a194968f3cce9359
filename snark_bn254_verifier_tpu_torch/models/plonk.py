"""Single-proof PlonK verification on PyTorch: the reference's public API.

The counterpart of snark_bn254_verifier_tpu/models/plonk.py
(``PlonkVerifier``, plonk.py:220-267 there; reference
verifier/src/lib.rs:69). The protocol logic is the JAX package's JAX-free
``verify_plonk``: the Fiat-Shamir transcript and the Fr algebra stay on
the host, the MSMs run on kernel K2 and the final two-pair KZG check on
K5 + K4, through a ``TorchBackend``.

As in the Groth16 facade, there is no batch-1 fast path: each call runs
one pipeline. Protocol failures raise the reference's errors
(``InvalidWitnessError``, ``OpeningPolyMismatchError``,
``PairingCheckFailedError``, ...); a proof that verifies returns True.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

from snark_bn254_verifier_tpu.models.plonk import verify_plonk
from snark_bn254_verifier_tpu.utils import serialization as ser

from .torch_backend import TorchBackend


class PlonkVerifier:
    """Public API facade. The parsed VK is cached by the sha256 of its
    bytes (it holds no device state)."""

    _vk_cache: dict = {}

    @staticmethod
    def verify(proof: bytes, vk: bytes, public_inputs: Sequence[int], device="cpu") -> bool:
        backend = TorchBackend(device)
        key = hashlib.sha256(vk).digest()
        vk_obj = PlonkVerifier._vk_cache.get(key)
        if vk_obj is None:
            vk_obj = ser.load_plonk_verifying_key_from_bytes(vk)
            PlonkVerifier._vk_cache[key] = vk_obj
        proof_obj = ser.load_plonk_proof_from_bytes(proof)
        return verify_plonk(vk_obj, proof_obj, public_inputs, backend=backend)

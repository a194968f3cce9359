"""Single-proof Groth16 verification on PyTorch: the reference's public API.

The counterpart of snark_bn254_verifier_tpu/models/groth16.py
(``Groth16Verifier``, groth16.py:85-145 there; reference
verifier/src/lib.rs:44). The protocol logic is the JAX package's JAX-free
``verify_groth16``, run on a ``TorchBackend``: one K2 call for the
prepared input, one K5 + K4 call for the three-pair product, each with one
copy back to the host.

The JAX facade first tries a batch-1 run of its batch verifier and falls
through to this generic path when that run fails, a workaround for device
round trips over a remote TPU attachment; here every call runs the one
path, so a failing proof pays once. The error taxonomy is the
reference's: ``PrepareInputsFailedError`` for a wrong input count, a parse
error for malformed bytes, ``False`` for a proof that does not verify.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

from snark_bn254_verifier_tpu.models.groth16 import PreparedVerifyingKey, verify_groth16
from snark_bn254_verifier_tpu.utils import serialization as ser

from .torch_backend import TorchBackend


class Groth16Verifier:
    """Public API facade. The parsed VK and its e(alpha, beta) (computed
    through K5 + K4 on the first call's device) are cached by the sha256 of
    the VK bytes: e(alpha, beta) is a host Fq12 value, the same on every
    device."""

    _cache: dict = {}

    @staticmethod
    def verify(proof: bytes, vk: bytes, public_inputs: Sequence[int], device="cpu") -> bool:
        backend = TorchBackend(device)
        key = hashlib.sha256(vk).digest()
        ent = Groth16Verifier._cache.get(key)
        if ent is None:
            vk_obj = ser.load_groth16_verifying_key_from_bytes(vk)
            ent = (vk_obj, PreparedVerifyingKey.from_vk(vk_obj, backend))
            Groth16Verifier._cache[key] = ent
        vk_obj, prepared = ent
        proof_obj = ser.load_groth16_proof_from_bytes(proof)
        return verify_groth16(vk_obj, proof_obj, public_inputs, backend=backend,
                              prepared=prepared)

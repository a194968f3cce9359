"""Plain Groth16 verification over BN254 (verifier/src/groth16/verify.rs of
snark-bn254-verifier), the reference the benchmark holds the port's
Groth16 verdicts against.

A proof verifies iff its bytes parse (codec.groth16_proof: canonical,
on the curve), the input count matches the VK's K points, and

    e(A, B) * e(k0 + sum in_i k_{i+1}, gamma) * e(C, -delta) == e(alpha, -beta)

(beta is negated at load). B is checked to lie on the twist, not in its
subgroup, as in the reference verifier.
"""

from __future__ import annotations

from typing import Sequence

from . import bn254 as bn
from . import codec


class Groth16Reference:
    """One VK, parsed once, with e(alpha, -beta) computed once."""

    def __init__(self, vk_bytes: bytes):
        self.vk = codec.groth16_vk(vk_bytes)
        self.alpha_beta = bn.pairing(self.vk.alpha, self.vk.beta_neg)
        self.neg_delta = bn.g2_neg(self.vk.delta)

    def verify(self, proof: bytes, inputs: Sequence[int], canonical: bool = True) -> bool:
        vk = self.vk
        try:
            a, b, c = codec.groth16_proof(proof, canonical)
        except codec.Reject:
            return False
        if len(inputs) + 1 != len(vk.k):
            return False
        acc = vk.k[0]
        for w, k in zip(inputs, vk.k[1:]):
            acc = bn.g1_add(acc, bn.g1_mul(k, w % bn.R))
        lhs = bn.pairing_batch([(a, b), (acc, vk.gamma), (c, self.neg_delta)])
        return lhs == self.alpha_beta


def verifier(vk_bytes: bytes, seed: int):
    """The reference's verdict function for the benchmark's check:
    ``verify(proof, inputs, canonical=True) -> bool``."""
    return Groth16Reference(vk_bytes).verify

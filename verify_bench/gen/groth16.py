"""Groth16 proofs with gnark's byte layout, valid by construction.

One VK a seed, its points known multiples of the generators (a trapdoor:
alpha, beta, gamma, delta and the K points' scalars). For inputs w and
random a, b, the scalar c of C solves the verifier's equation

    a b + (k0 + sum w_i k_{i+1}) gamma - c delta == -alpha beta  (mod r)

so every proof verifies, through the real byte formats. The layout is
SP1's wrapper circuit's (a configuration's ``num_public_inputs``,
``proof_commitments`` and ``committed_array_lens``): the proof carries
A, B, C, a commitment count, the commitments and their proof of
knowledge (past byte 256, which the verifier does not read); the VK
carries its K points, the committed arrays and two Pedersen keys.

Fault kinds (each on a proof of its own): ``a_corrupted`` (a byte of A.x
flipped: off the curve), ``b_off_curve`` (B.y changed), ``wrong_value``
(input 0 plus one), ``wrong_count`` (the last input dropped),
``other_statement`` (a valid proof of other inputs), ``noncanonical_a``
(A.x plus p: the same point, not canonically encoded).
"""

from __future__ import annotations

import random
import struct

from ..reference import bn254 as bn
from ..reference import codec
from .fixed_base import tables

R = bn.R
KINDS = ("a_corrupted", "b_off_curve", "wrong_value", "wrong_count", "other_statement",
         "noncanonical_a")


def _fr(rng: random.Random) -> int:
    return rng.randrange(1, R - 1)


class Groth16Gen:
    """A trapdoor VK from ``rng`` and proofs under it."""

    def __init__(self, cfg: dict, rng: random.Random):
        g1, g2 = tables()
        self.g1, self.g2, self.rng = g1.mul, g2.mul, rng
        self.n_inputs = cfg["num_public_inputs"]
        self.n_commitments = cfg["proof_commitments"]
        self.alpha, self.beta, self.gamma, self.delta = (_fr(rng) for _ in range(4))
        self.kappas = [_fr(rng) for _ in range(self.n_inputs + 1)]
        self.delta_inv = pow(self.delta, -1, R)
        c1, c2 = codec.g1_compressed_bytes, codec.g2_compressed_bytes
        vk = [c1(self.g1(self.alpha)), c1(self.g1(self.beta)), c2(self.g2(self.beta)),
              c2(self.g2(self.gamma)), c1(self.g1(self.delta)), c2(self.g2(self.delta)),
              struct.pack(">I", len(self.kappas))]
        vk += [c1(self.g1(k)) for k in self.kappas]
        arrays = cfg["committed_array_lens"]
        vk.append(struct.pack(">I", len(arrays)))
        for n in arrays:
            vk.append(struct.pack(f">I{n}I", n, *range(1, n + 1)))
        vk += [c2(self.g2(_fr(rng))), c2(self.g2(_fr(rng)))]  # Pedersen keys
        self.vk = b"".join(vk)

    def inputs(self) -> list:
        return [_fr(self.rng) for _ in range(self.n_inputs)]

    def proof(self, inputs) -> bytes:
        rng = self.rng
        a, b = _fr(rng), _fr(rng)
        pi = self.kappas[0] + sum(w * k for w, k in zip(inputs, self.kappas[1:]))
        c = (a * b + pi * self.gamma + self.alpha * self.beta) * self.delta_inv % R
        out = [codec.g1_bytes(self.g1(a)), codec.g2_bytes(self.g2(b)),
               codec.g1_bytes(self.g1(c)), struct.pack(">I", self.n_commitments)]
        out += [codec.g1_bytes(self.g1(_fr(rng))) for _ in range(self.n_commitments + 1)]
        return b"".join(out)

    def bad(self, kind: str, proof: bytes, inputs: list):
        """(proof, inputs) of fault ``kind`` made from a valid pair."""
        if kind == "a_corrupted":
            return proof[:5] + bytes([proof[5] ^ 0xFF]) + proof[6:], inputs
        if kind == "b_off_curve":
            return proof[:191] + bytes([proof[191] ^ 1]) + proof[192:], inputs
        if kind == "wrong_value":
            return proof, [inputs[0] + 1] + inputs[1:]
        if kind == "wrong_count":
            return proof, inputs[:-1]
        if kind == "other_statement":
            return self.proof(self.inputs()), inputs
        if kind == "noncanonical_a":
            x = int.from_bytes(proof[:32], "big") + bn.P
            return x.to_bytes(32, "big") + proof[32:], inputs
        raise ValueError(f"unknown Groth16 fault kind {kind!r}")

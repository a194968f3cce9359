"""Seeded lanes of the PlonK batch verifier (parallel/batch.py::
PlonkBatchVerifier): the synthetic BSB22 vector with bad lanes of every
kind the verifier must reject, at the positions the caller names. Shared
by the PlonK batch's tests and chip_smoke.py, each at its own size."""

from __future__ import annotations

import struct

from ..oracle import bn254 as bn
from ..utils import serialization as ser
from .gen import gen_plonk_vector

KINDS = (
    "opening_doubled",   # batched_proof.h doubled: only the pairing rejects it
    "shifted_doubled",   # z_shifted_opening.h doubled: the pairing rejects it
    "wrong_value",       # public input 0 plus one
    "claimed0",          # claimed_values[0] corrupted: the linearisation check
    "truncated",         # the proof cut short: the parser rejects it
    "other_statement",   # a proof of another vector's statement
    "wrong_count",       # one public input too few
    "extra_claimed",     # one claimed value too many: the parser's count check
)


def _double_g1_at(proof: bytes, off: int) -> bytes:
    pt = ser.uncompressed_to_g1(proof[off:off + 64])
    return proof[:off] + ser.g1_to_bytes(bn.g1_mul(pt, 2)) + proof[off + 64:]


def plonk_batch_lanes(batch: int, bad: dict):
    """(vector, proofs, inputs, expected) for ``batch`` lanes of
    ``gen_plonk_vector(0)``; ``bad`` maps a lane to one of KINDS. Lanes
    outside it hold the good proof; ``expected`` is True there only."""
    vec = gen_plonk_vector(0)
    ins = list(vec.public_inputs)
    (n_claimed,) = struct.unpack_from(">I", vec.proof, 512)
    claimed0 = bytearray(vec.proof)
    claimed0[516 + 31] ^= 1
    end = 516 + 32 * n_claimed  # one more claimed value, a copy of the first
    extra = (vec.proof[:512] + struct.pack(">I", n_claimed + 1) + vec.proof[516:end]
             + vec.proof[516:548] + vec.proof[end:])
    variants = {
        "opening_doubled": lambda: (_double_g1_at(vec.proof, 7 * 64), ins),
        "shifted_doubled": lambda: (_double_g1_at(vec.proof, 516 + 32 * n_claimed), ins),
        "wrong_value": lambda: (vec.proof, [ins[0] + 1] + ins[1:]),
        "claimed0": lambda: (bytes(claimed0), ins),
        "truncated": lambda: (vec.proof[:600], ins),
        "other_statement": lambda: (gen_plonk_vector(1).proof, ins),
        "wrong_count": lambda: (vec.proof, ins[:-1]),
        "extra_claimed": lambda: (extra, ins),
    }
    made = {kind: variants[kind]() for kind in set(bad.values())}
    proofs, inputs, expected = [], [], []
    for lane in range(batch):
        proof, lane_ins = made[bad[lane]] if lane in bad else (vec.proof, ins)
        proofs.append(proof)
        inputs.append(list(lane_ins))
        expected.append(lane not in bad)
    return vec, proofs, inputs, expected

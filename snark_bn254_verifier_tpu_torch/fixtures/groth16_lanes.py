"""Seeded lanes of the Groth16 batch verifier (parallel/batch.py::
Groth16BatchVerifier): the bench vector with bad lanes at fixed positions.
Shared by chip_smoke.py (the slice at batch 1024) and the tests."""

from __future__ import annotations

from ..oracle import bn254 as bn
from .gen import gen_groth16_vector


# Lane -> fault kind of ``groth16_batch_lanes``.
KINDS = {3: "a_corrupted", 5: "b_off_curve", 7: "wrong_value", 11: "wrong_count",
         13: "other_statement", 17: "noncanonical_a"}


def groth16_batch_lanes(batch: int, num_inputs: int = 2):
    """(vector, proofs, inputs, expected): ``gen_groth16_vector(0,
    num_inputs)`` at ``batch`` proofs, with bad lanes (KINDS) at 3 (A
    corrupted), 5 (B off the curve), 7 (wrong input values), 11 (wrong
    input count), 13 (a proof of another statement) and 17 (A.x + p: the
    same point, not canonically encoded) where the batch reaches them; all
    proofs keep one length, so the native parser runs."""
    vec = gen_groth16_vector(0, num_inputs=num_inputs)
    other = gen_groth16_vector(1, num_inputs=num_inputs)
    proofs = [vec.proof] * batch
    inputs = [list(vec.public_inputs) for _ in range(batch)]
    expected = [True] * batch
    bad_a = bytearray(vec.proof)
    bad_a[5] ^= 0xFF                  # corrupt A.x
    off_b = bytearray(vec.proof)
    off_b[64 + 127] ^= 1              # B.y changed: B off the curve
    wide_a = (int.from_bytes(vec.proof[:32], "big") + bn.P).to_bytes(32, "big")
    bad = {
        3: ("proof", bytes(bad_a)),
        5: ("proof", bytes(off_b)),
        7: ("inputs", [v + 1 for v in vec.public_inputs]),  # wrong input values
        11: ("inputs", list(vec.public_inputs[:-1])),       # wrong input count
        13: ("proof", other.proof),   # a proof of another statement
        17: ("proof", wide_a + vec.proof[32:]),
    }
    for lane, (kind, val) in bad.items():
        if lane >= batch:
            continue
        if kind == "proof":
            proofs[lane] = val
        else:
            inputs[lane] = val
        expected[lane] = False
    return vec, proofs, inputs, expected

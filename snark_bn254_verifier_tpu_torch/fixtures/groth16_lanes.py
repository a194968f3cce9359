"""Seeded lanes of the Groth16 batch verifier (parallel/batch.py::
Groth16BatchVerifier): the bench vector with bad lanes at fixed positions.
Shared by chip_smoke.py (the slice at batch 1024) and the tests."""

from __future__ import annotations

from .gen import gen_groth16_vector


def groth16_batch_lanes(batch: int):
    """(vector, proofs, inputs, expected): ``gen_groth16_vector(0,
    num_inputs=2)`` at ``batch`` proofs, with bad lanes at 3 (A corrupted),
    5 (B off the curve), 7 (wrong input values), 11 (wrong input count) and
    13 (a proof of another statement) where the batch reaches them; all
    proofs keep one length, so the native parser runs."""
    vec = gen_groth16_vector(0, num_inputs=2)
    other = gen_groth16_vector(1, num_inputs=2)
    proofs = [vec.proof] * batch
    inputs = [list(vec.public_inputs) for _ in range(batch)]
    expected = [True] * batch
    bad_a = bytearray(vec.proof)
    bad_a[5] ^= 0xFF                  # corrupt A.x
    off_b = bytearray(vec.proof)
    off_b[64 + 127] ^= 1              # B.y changed: B off the curve
    bad = {
        3: ("proof", bytes(bad_a)),
        5: ("proof", bytes(off_b)),
        7: ("inputs", [1, 2]),        # wrong input values
        11: ("inputs", [1]),          # wrong input count
        13: ("proof", other.proof),   # a proof of another statement
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

"""KZG batch-opening verification (gnark-compatible semantics).

Mirrors verifier/src/plonk/kzg.rs:

  * ``derive_gamma`` — a fresh single-challenge "gamma" transcript binding
    the evaluation point, all digests, all claimed values and optional extra
    transcript bytes (kzg.rs:46-72).
  * ``fold_proof`` — powers-of-gamma linear combination (kzg.rs:87-126).
  * ``batch_verify_multi_points`` — random linear combination with
    coefficients [1, r1, ...] then the 2-pairing check
    e(fold_D, G2) * e(-fold_Q, [alpha]G2) == 1 (kzg.rs:128-190).

Improvement over the reference: the single-digest path is implemented
properly instead of ``todo!()`` (kzg.rs:146-148).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..oracle import bn254 as bn
from ..utils import errors
from ..utils import serialization as ser
from ..utils.transcript import GAMMA, Transcript
from .backend import get_backend


def derive_gamma(
    point: int,
    digests: Sequence[ser.G1Point],
    claimed_values: Sequence[int],
    data_transcript: Optional[bytes] = None,
) -> int:
    transcript = Transcript([GAMMA])
    transcript.bind(GAMMA, ser.fr_to_bytes_be(point))
    for digest in digests:
        transcript.bind(GAMMA, ser.g1_to_bytes(digest))
    for value in claimed_values:
        transcript.bind(GAMMA, ser.fr_to_bytes_be(value))
    if data_transcript is not None:
        transcript.bind(GAMMA, data_transcript)
    return ser.fr_from_bytes_be_mod_order(transcript.compute_challenge(GAMMA))


def fold(
    digests: Sequence[ser.G1Point],
    evals: Sequence[int],
    coeffs: Sequence[int],
    backend=None,
) -> Tuple[ser.G1Point, int]:
    backend = get_backend(backend)
    folded_eval = 0
    for e, c in zip(evals, coeffs):
        folded_eval = (folded_eval + e * c) % bn.R
    folded_digest = backend.msm(list(digests), list(coeffs))
    return folded_digest, folded_eval


def fold_proof(
    digests: Sequence[ser.G1Point],
    batch_opening_proof: ser.BatchOpeningProof,
    point: int,
    data_transcript: Optional[bytes] = None,
    backend=None,
) -> Tuple[ser.OpeningProof, ser.G1Point]:
    nb = len(digests)
    if nb != len(batch_opening_proof.claimed_values):
        raise errors.InvalidNumberOfDigestsError(nb)
    gamma = derive_gamma(point, digests, batch_opening_proof.claimed_values, data_transcript)
    coeffs = [1] * nb
    for i in range(1, nb):
        coeffs[i] = coeffs[i - 1] * gamma % bn.R
    folded_digest, folded_eval = fold(
        digests, batch_opening_proof.claimed_values, coeffs, backend
    )
    return ser.OpeningProof(h=batch_opening_proof.h, claimed_value=folded_eval), folded_digest


def batch_verify_multi_points(
    digests: Sequence[ser.G1Point],
    proofs: Sequence[ser.OpeningProof],
    points: Sequence[int],
    vk: ser.KZGVerifyingKey,
    backend=None,
    rng=None,
) -> None:
    """Raises PairingCheckFailedError on an invalid opening; returns None on
    success (matching the reference's Result<(), _> shape)."""
    backend = get_backend(backend)
    nb = len(digests)
    if nb != len(proofs) or nb != len(points):
        raise errors.InvalidNumberOfDigestsError(nb)
    # soundness randomizers: coeff[0] fixed to one, the rest unpredictable
    rand_fr = rng if rng is not None else (lambda: secrets.randbelow(bn.R - 1) + 1)
    random_numbers = [1] + [rand_fr() for _ in range(nb - 1)]

    quotients = [pr.h for pr in proofs]
    folded_quotients = backend.msm(quotients, random_numbers)
    evals = [pr.claimed_value for pr in proofs]
    folded_digests, folded_evals = fold(digests, evals, random_numbers, backend)
    folded_evals_commit = backend.g1_mul(vk.g1, folded_evals)
    folded_digests = bn.g1_add(folded_digests, bn.g1_neg(folded_evals_commit))

    zi_ri = [r * z % bn.R for r, z in zip(random_numbers, points)]
    folded_points_quotients = backend.msm(quotients, zi_ri)
    folded_digests = bn.g1_add(folded_digests, folded_points_quotients)
    folded_quotients = bn.g1_neg(folded_quotients)

    ok = backend.pairing_batch_is_one(
        [
            (folded_digests, vk.g2[0]),
            (folded_quotients, vk.g2[1]),
        ]
    )
    if not ok:
        raise errors.PairingCheckFailedError()

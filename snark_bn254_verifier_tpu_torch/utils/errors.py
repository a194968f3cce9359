"""Exception hierarchy mirroring the reference's error enums.

Mirrors the three enums of the reference: the shared 22-variant ``Error``
(verifier/src/error.rs:5-59), ``Groth16Error`` (verifier/src/groth16/error.rs:4-15)
and ``PlonkError`` (verifier/src/plonk/error.rs:4-47). Python exceptions replace
Rust Result variants; batched device verification instead reports per-lane
False without raising (see parallel/batch.py).
"""

from __future__ import annotations


class VerifierError(Exception):
    """Base class: the shared Error enum (verifier/src/error.rs:5)."""


# --- crypto / protocol errors ---------------------------------------------


class Bsb22CommitmentMismatchError(VerifierError):
    pass


class ChallengeAlreadyComputedError(VerifierError):
    pass


class ChallengeNotFoundError(VerifierError):
    pass


class PreviousChallengeNotComputedError(VerifierError):
    pass


class PairingCheckFailedError(VerifierError):
    pass


class InvalidWitnessError(VerifierError):
    pass


class InvalidPointError(VerifierError):
    pass


class InvalidXLengthError(VerifierError):
    pass


class InverseNotFoundError(VerifierError):
    pass


class OpeningPolyMismatchError(VerifierError):
    """Linearization-polynomial opening mismatch (plonk/verify.rs:212)."""


class InvalidNumberOfDigestsError(VerifierError):
    pass


class BeyondTheModulusError(VerifierError):
    pass


class EllTooLargeError(VerifierError):
    pass


class DSTTooLargeError(VerifierError):
    pass


class FailedToGetFrFromRandomBytesError(VerifierError):
    pass


class PrepareInputsFailedError(VerifierError):
    """Groth16 public-input count mismatch (groth16/verify.rs:55)."""


class FieldError(VerifierError):
    """Non-canonical field encoding (value >= modulus), NotMemberOfField."""


class GroupError(VerifierError):
    """Point not on curve / not in group."""


class Groth16Error(VerifierError):
    """Namespace parent matching groth16/error.rs."""


class PlonkError(VerifierError):
    """Namespace parent matching plonk/error.rs."""

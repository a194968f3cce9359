"""gnark-compatible named-challenge Fiat-Shamir transcript over SHA-256.

Bit-exact reproduction of the reference transcript semantics
(verifier/src/transcript.rs): challenges are declared up-front in order;
``bind`` appends data to a not-yet-computed challenge; ``compute_challenge``
hashes ``SHA256(challenge_name || previous_challenge_value || bindings...)``
— the name first (transcript.rs:81), the previous challenge's 32-byte value
required for any position > 0 (transcript.rs:83-92), and the result memoized
(transcript.rs:74-76).

This is inherently sequential byte-oriented work and stays on host; the
device pipeline consumes the derived Fr challenges.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence

from . import errors

GAMMA = "gamma"
BETA = "beta"
ALPHA = "alpha"
ZETA = "zeta"


class _Challenge:
    __slots__ = ("position", "bindings", "value", "is_computed")

    def __init__(self, position: int):
        self.position = position
        self.bindings: List[bytes] = []
        self.value = b""
        self.is_computed = False


class Transcript:
    """Named-challenge transcript; challenge order fixed at construction."""

    def __init__(self, challenge_ids: Optional[Sequence[str]] = None):
        self._challenges: Dict[str, _Challenge] = {}
        self._previous: Optional[_Challenge] = None
        if challenge_ids:
            for position, cid in enumerate(challenge_ids):
                self._challenges[cid] = _Challenge(position)

    def bind(self, challenge_id: str, data: bytes) -> None:
        ch = self._challenges.get(challenge_id)
        if ch is None:
            raise errors.ChallengeNotFoundError(challenge_id)
        if ch.is_computed:
            raise errors.ChallengeAlreadyComputedError(challenge_id)
        ch.bindings.append(bytes(data))

    def compute_challenge(self, challenge_id: str) -> bytes:
        ch = self._challenges.get(challenge_id)
        if ch is None:
            raise errors.ChallengeNotFoundError(challenge_id)
        if ch.is_computed:
            return ch.value
        h = hashlib.sha256()
        h.update(challenge_id.encode())
        if ch.position != 0:
            if self._previous is None or self._previous.position != ch.position - 1:
                raise errors.PreviousChallengeNotComputedError(challenge_id)
            h.update(self._previous.value)
        for binding in ch.bindings:
            h.update(binding)
        ch.value = h.digest()
        ch.is_computed = True
        self._previous = ch
        return ch.value

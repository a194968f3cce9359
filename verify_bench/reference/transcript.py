"""gnark's Fiat-Shamir transcript and BSB22's hash to field, over SHA-256.

A challenge is SHA-256(name || previous challenge || its bindings), the
challenges taken in their declared order (verifier/src/transcript.rs);
hash to field is RFC 9380's expand_message_xmd with SHA-256, 48 bytes an
element (verifier/src/hash_to_field.rs).
"""

from __future__ import annotations

import hashlib

from . import bn254 as bn


class Transcript:
    """Challenges in a fixed order; each is computed once, after the one
    before it, from the data bound to it."""

    def __init__(self, *names: str):
        self.order = list(names)
        self.bound = {n: [] for n in names}
        self.done = []  # the digests computed so far, in order

    def bind(self, name: str, data: bytes) -> None:
        if self.order.index(name) < len(self.done):
            raise ValueError(f"challenge {name} already computed")
        self.bound[name].append(bytes(data))

    def challenge(self, name: str) -> int:
        """The challenge as an Fr element (its digest reduced mod r)."""
        pos = self.order.index(name)
        if pos != len(self.done):
            raise ValueError(f"challenge {name} out of order")
        h = hashlib.sha256(name.encode())
        if pos:
            h.update(self.done[-1])
        for data in self.bound[name]:
            h.update(data)
        self.done.append(h.digest())
        return int.from_bytes(self.done[-1], "big") % bn.R


def expand_message_xmd(msg: bytes, dst: bytes, length: int) -> bytes:
    ell = (length + 31) // 32
    dst_prime = dst + bytes([len(dst)])
    b0 = hashlib.sha256(bytes(64) + msg + length.to_bytes(2, "big") + b"\x00"
                        + dst_prime).digest()
    bi = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = bi
    for i in range(2, ell + 1):
        bi = hashlib.sha256(bytes(x ^ y for x, y in zip(b0, bi)) + bytes([i])
                            + dst_prime).digest()
        out += bi
    return out[:length]


def hash_to_fr(msg: bytes, dst: bytes) -> int:
    return int.from_bytes(expand_message_xmd(msg, dst, 48), "big") % bn.R

"""RFC-9380 expand_msg_xmd (SHA-256) and the gnark hash-to-field wrapper.

Bit-exact reproduction of verifier/src/hash_to_field.rs: L = 16 + 32 = 48
bytes per element (hash_to_field.rs:31-34), used by the PlonK verifier for
BSB22 custom-gate commitments with DST ``b"BSB22-Plonk"``
(plonk/verify.rs:140).
"""

from __future__ import annotations

import hashlib
from typing import List

from . import errors

_SHA256_BLOCK_SIZE = 64


def expand_msg_xmd(msg: bytes, dst: bytes, length: int) -> bytes:
    """RFC-9380 §5.3.1 expand_message_xmd with SHA-256."""
    ell = (length + 31) // 32
    if ell > 255:
        raise errors.EllTooLargeError(ell)
    if len(dst) > 255:
        raise errors.DSTTooLargeError(len(dst))
    dst_prime = dst + bytes([len(dst)])
    h = hashlib.sha256()
    h.update(b"\x00" * _SHA256_BLOCK_SIZE)
    h.update(msg)
    h.update(bytes([(length >> 8) & 0xFF, length & 0xFF, 0]))
    h.update(dst_prime)
    b0 = h.digest()
    h = hashlib.sha256()
    h.update(b0)
    h.update(b"\x01")
    h.update(dst_prime)
    bi = h.digest()
    out = bytearray(bi)
    for i in range(2, ell + 1):
        h = hashlib.sha256()
        h.update(bytes(x ^ y for x, y in zip(b0, bi)))
        h.update(bytes([i]))
        h.update(dst_prime)
        bi = h.digest()
        out.extend(bi)
    return bytes(out[:length])


def hash_to_field_bytes(msg: bytes, dst: bytes, count: int = 1) -> List[bytes]:
    """48 bytes of uniform output per element (hash_to_field.rs:24-43)."""
    l = 16 + 32
    prb = expand_msg_xmd(msg, dst, count * l)
    return [prb[i * l : (i + 1) * l] for i in range(count)]


class WrappedHashToField:
    """Accumulator matching the reference's core::hash::Hasher wrapper
    (hash_to_field.rs:100-121): ``write`` appends bytes, ``sum`` hashes the
    accumulated bytes with count=1, ``reset`` clears."""

    def __init__(self, domain_separator: bytes = b""):
        self.domain = bytes(domain_separator)
        self.to_hash = bytearray()

    def write(self, data: bytes) -> None:
        self.to_hash.extend(data)

    def sum(self) -> bytes:
        return hash_to_field_bytes(bytes(self.to_hash), self.domain, 1)[0]

    def reset(self) -> None:
        self.to_hash.clear()

"""gnark's byte formats over BN254, read and written in plain Python.

Readers (the reference verifiers' side) follow the semantics of the
reference verifier's converters (verifier/src/{groth16,plonk}/converter.rs
of snark-bn254-verifier): a coordinate or scalar is a 32-byte big-endian
integer that must be below its modulus (substrate-bn's ``from_slice``), an
uncompressed point must lie on its curve (so the all-zero encoding is
refused), and any short or malformed input is a rejection. Writers (the
proof generator's side) produce the same layouts.

``canonical=False`` in a reader reduces an out-of-range value modulo its
modulus instead of refusing it: the one guarantee the benchmark's control
breaks (verify_bench/control.py). Nothing else reads it.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Tuple

from . import bn254 as bn

MASK = 0b11 << 6
FLAG_POSITIVE = 0b10 << 6
FLAG_NEGATIVE = 0b11 << 6
FLAG_INFINITY = 0b01 << 6
# gnark's PlonK vk.WriteTo carries precomputed Miller lines that the
# verifier skips (plonk/converter.rs:58)
PLONK_VK_LINES_BYTES = 33788


class Reject(Exception):
    """The bytes, the inputs or the proof's equations do not verify."""


# -- field elements -----------------------------------------------------------

def _int(buf: bytes, modulus: int, canonical: bool) -> int:
    if len(buf) != 32:
        raise Reject(f"a field element of {len(buf)} bytes")
    v = int.from_bytes(buf, "big")
    if v >= modulus:
        if canonical:
            raise Reject("a field element not below its modulus")
        v %= modulus
    return v


def fq(buf: bytes, canonical: bool = True) -> int:
    return _int(buf, bn.P, canonical)


def fr(buf: bytes, canonical: bool = True) -> int:
    return _int(buf, bn.R, canonical)


def fr_bytes(v: int) -> bytes:
    return (v % bn.R).to_bytes(32, "big")


def u32(buf: bytes, off: int) -> int:
    if off + 4 > len(buf):
        raise Reject("a count past the end")
    return struct.unpack_from(">I", buf, off)[0]


# -- points -------------------------------------------------------------------

def g1(buf: bytes, canonical: bool = True):
    """64 bytes x || y, on the curve."""
    if len(buf) != 64:
        raise Reject(f"a G1 point of {len(buf)} bytes")
    pt = (fq(buf[:32], canonical), fq(buf[32:], canonical))
    if not bn.g1_is_on_curve(pt):
        raise Reject("a G1 point off the curve")
    return pt


def g2(buf: bytes, canonical: bool = True):
    """128 bytes x1 || x0 || y1 || y0, on the twist."""
    if len(buf) != 128:
        raise Reject(f"a G2 point of {len(buf)} bytes")
    x1, x0, y1, y0 = (fq(buf[i:i + 32], canonical) for i in range(0, 128, 32))
    pt = ((x0, x1), (y0, y1))
    if not bn.g2_is_on_curve(pt):
        raise Reject("a G2 point off the twist")
    return pt


def _flagged_x(buf: bytes):
    flag = buf[0] & MASK
    if flag == FLAG_INFINITY:
        raise Reject("a VK point at infinity")
    if flag not in (FLAG_POSITIVE, FLAG_NEGATIVE):
        raise Reject("an unknown point flag")
    return int.from_bytes(bytes([buf[0] & ~MASK & 0xFF]) + buf[1:32], "big") % bn.P, flag


def g1_compressed(buf: bytes):
    x, flag = _flagged_x(buf)
    y = bn.fq_sqrt((x * x % bn.P * x + bn.B_G1) % bn.P)
    if y is None:
        raise Reject("a compressed G1 x off the curve")
    small, big = sorted((y, (bn.P - y) % bn.P))
    return (x, big if flag == FLAG_NEGATIVE else small)


def g2_compressed(buf: bytes):
    x1, flag = _flagged_x(buf[:32])
    x = (int.from_bytes(buf[32:64], "big") % bn.P, x1)
    y = bn.fq2_sqrt(bn.fq2_add(bn.fq2_mul(bn.fq2_sq(x), x), bn.B_G2))
    if y is None:
        raise Reject("a compressed G2 x off the twist")
    big = y if bn.fq2_lexicographically_largest(y) else bn.fq2_neg(y)
    small = bn.fq2_neg(big)
    return (x, big if flag == FLAG_NEGATIVE else small)


def g1_bytes(pt) -> bytes:
    if pt is None:
        return bytes(64)
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def g2_bytes(pt) -> bytes:
    (x0, x1), (y0, y1) = pt
    return b"".join(v.to_bytes(32, "big") for v in (x1, x0, y1, y0))


def g1_compressed_bytes(pt) -> bytes:
    x, y = pt
    out = bytearray(x.to_bytes(32, "big"))
    out[0] |= FLAG_NEGATIVE if y > (bn.P - 1) // 2 else FLAG_POSITIVE
    return bytes(out)


def g2_compressed_bytes(pt) -> bytes:
    (x0, x1), y = pt
    out = bytearray(x1.to_bytes(32, "big") + x0.to_bytes(32, "big"))
    out[0] |= FLAG_NEGATIVE if bn.fq2_lexicographically_largest(y) else FLAG_POSITIVE
    return bytes(out)


# -- Groth16 (groth16/converter.rs) ------------------------------------------

@dataclass
class Groth16Vk:
    alpha: tuple
    beta_neg: tuple       # beta in G2, negated at load (converter.rs:79)
    gamma: tuple
    delta: tuple
    k: List[tuple]


def groth16_vk(buf: bytes) -> Groth16Vk:
    """alpha G1 | beta G1 | beta G2 | gamma G2 | delta G1 | delta G2 |
    u32 count | K points, all compressed; the committed arrays and the
    Pedersen keys after them are not read by the verifier."""
    n_k = u32(buf, 288)
    k = [g1_compressed(buf[292 + 32 * i:324 + 32 * i]) for i in range(n_k)]
    return Groth16Vk(alpha=g1_compressed(buf[0:32]),
                     beta_neg=bn.g2_neg(g2_compressed(buf[64:128])),
                     gamma=g2_compressed(buf[128:192]), delta=g2_compressed(buf[224:288]), k=k)


def groth16_proof(buf: bytes, canonical: bool = True):
    """(A, B, C): bytes [0, 64), [64, 192), [192, 256); the commitments and
    their proof of knowledge after byte 256 are not read (converter.rs:14-25)."""
    if len(buf) < 256:
        raise Reject("a Groth16 proof shorter than 256 bytes")
    return g1(buf[0:64], canonical), g2(buf[64:192], canonical), g1(buf[192:256], canonical)


# -- PlonK (plonk/converter.rs) -----------------------------------------------

@dataclass
class PlonkVk:
    size: int
    size_inv: int
    omega: int
    nb_pub: int
    coset_shift: int
    s: Tuple[tuple, tuple, tuple]
    ql: tuple
    qr: tuple
    qm: tuple
    qo: tuple
    qk: tuple
    qcp: List[tuple]
    kzg_g1: tuple
    kzg_g2: Tuple[tuple, tuple]
    cci: List[int]


def plonk_vk(buf: bytes) -> PlonkVk:
    size = struct.unpack_from(">Q", buf, 0)[0]
    nb_pub = struct.unpack_from(">Q", buf, 72)[0]
    pts = [g1_compressed(buf[112 + 32 * i:144 + 32 * i]) for i in range(8)]
    n_qcp = u32(buf, 368)
    off = 372 + 32 * n_qcp
    qcp = [g1_compressed(buf[372 + 32 * i:404 + 32 * i]) for i in range(n_qcp)]
    kzg_g1 = g1_compressed(buf[off:off + 32])
    kzg_g2 = (g2_compressed(buf[off + 32:off + 96]), g2_compressed(buf[off + 96:off + 160]))
    off += 160 + PLONK_VK_LINES_BYTES
    n_cci = struct.unpack_from(">Q", buf, off)[0]
    cci = list(struct.unpack_from(f">{n_cci}Q", buf, off + 8))
    return PlonkVk(size=size, size_inv=fr(buf[8:40]), omega=fr(buf[40:72]), nb_pub=nb_pub,
                   coset_shift=fr(buf[80:112]), s=tuple(pts[:3]), ql=pts[3], qr=pts[4],
                   qm=pts[5], qo=pts[6], qk=pts[7], qcp=qcp, kzg_g1=kzg_g1, kzg_g2=kzg_g2,
                   cci=cci)


@dataclass
class PlonkProof:
    lro: List[tuple]
    z: tuple
    h: List[tuple]
    opening_h: tuple
    claimed: List[int]
    shifted_h: tuple
    shifted_value: int
    bsb22: List[tuple] = field(default_factory=list)


def plonk_proof(buf: bytes, canonical: bool = True) -> PlonkProof:
    """L, R, O, Z, H0-H2, the batched opening's H (uncompressed G1), u32
    count and claimed values, the shifted opening's H and value, u32 count
    and the BSB22 commitments."""
    def pt(off):
        return g1(buf[off:off + 64], canonical)

    def val(off):
        return fr(buf[off:off + 32], canonical)

    g1s = [pt(64 * i) for i in range(8)]
    n_claimed = u32(buf, 512)
    claimed = [val(516 + 32 * i) for i in range(n_claimed)]
    off = 516 + 32 * n_claimed
    shifted_h, shifted_value = pt(off), val(off + 64)
    n_bsb = u32(buf, off + 96)
    bsb22 = [pt(off + 100 + 64 * i) for i in range(n_bsb)]
    return PlonkProof(lro=g1s[0:3], z=g1s[3], h=g1s[4:7], opening_h=g1s[7], claimed=claimed,
                      shifted_h=shifted_h, shifted_value=shifted_value, bsb22=bsb22)

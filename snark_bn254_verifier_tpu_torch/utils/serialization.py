"""gnark wire-format codecs (host side).

Byte-compatible with the reference's converters:
  * shared point codecs     — verifier/src/converter.rs
  * flag constants          — verifier/src/constants.rs:6-9
  * Groth16 proof/VK layout — verifier/src/groth16/converter.rs:14,28
  * PlonK proof/VK layout   — verifier/src/plonk/converter.rs:18,121,180

Points are returned in the oracle representation: G1 = (x, y) ints or None
for infinity; G2 = ((x0,x1),(y0,y1)) Fq2 tuples or None.

Documented divergences from the reference (never exercised by real gnark
vectors, see SURVEY.md §7):
  * compressed *infinity* G2 decodes to the identity here; the reference
    returns the G2 generator (converter.rs:100-102).
  * compressed *infinity* G1 decodes to the identity here; the reference's
    unchecked path would attempt sqrt(3) on x=0 (converter.rs:62-76).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..oracle import bn254 as bn
from . import errors

# Compressed-point flags: top two bits of byte 0 (constants.rs:6-9)
MASK = 0b11 << 6
FLAG_POSITIVE = 0b10 << 6
FLAG_NEGATIVE = 0b11 << 6
FLAG_INFINITY = 0b01 << 6

G1Point = Optional[Tuple[int, int]]
G2Point = Optional[Tuple[Tuple[int, int], Tuple[int, int]]]


# ---------------------------------------------------------------------------
# Field element codecs
# ---------------------------------------------------------------------------


def fq_from_slice(buf: bytes) -> int:
    """Canonical big-endian Fq; errors if value >= p (bn Fq::from_slice)."""
    if len(buf) != 32:
        raise errors.InvalidXLengthError(len(buf))
    v = int.from_bytes(buf, "big")
    if v >= bn.P:
        raise errors.FieldError("Fq encoding not canonical (>= p)")
    return v


def fr_from_slice(buf: bytes) -> int:
    """Canonical big-endian Fr; errors if value >= r (bn Fr::from_slice)."""
    if len(buf) != 32:
        raise errors.InvalidXLengthError(len(buf))
    v = int.from_bytes(buf, "big")
    if v >= bn.R:
        raise errors.FieldError("Fr encoding not canonical (>= r)")
    return v


def fr_from_bytes_be_mod_order(buf: bytes) -> int:
    return int.from_bytes(buf, "big") % bn.R


def fq_from_bytes_be_mod_order(buf: bytes) -> int:
    return int.from_bytes(buf, "big") % bn.P


def fr_to_bytes_be(v: int) -> bytes:
    return (v % bn.R).to_bytes(32, "big")


# ---------------------------------------------------------------------------
# Point codecs (converter.rs semantics)
# ---------------------------------------------------------------------------


def deserialize_with_flags(buf: bytes) -> Tuple[int, int]:
    """32-byte BE x with the flag in the top 2 bits (converter.rs:23-44)."""
    if len(buf) != 32:
        raise errors.InvalidXLengthError(len(buf))
    flag = buf[0] & MASK
    if flag == FLAG_INFINITY:
        if (buf[0] & ~MASK) != 0 or any(buf[1:]):
            raise errors.InvalidPointError("infinity flag with nonzero bits")
        return 0, FLAG_INFINITY
    if flag not in (FLAG_POSITIVE, FLAG_NEGATIVE):
        raise errors.InvalidPointError("invalid compressed point flag")
    x = bytes([buf[0] & ~MASK]) + buf[1:]
    return int.from_bytes(x, "big") % bn.P, flag


def compressed_to_g1(buf: bytes) -> G1Point:
    """Decompress a gnark G1 point (converter.rs:46-76 semantics).

    Flag NEGATIVE selects the lexicographically larger y (> (p-1)/2),
    POSITIVE the smaller.
    """
    x, flag = deserialize_with_flags(buf)
    if flag == FLAG_INFINITY:
        return None
    y = bn.fq_sqrt((x * x % bn.P * x + bn.B_G1) % bn.P)
    if y is None:
        raise errors.InvalidPointError("x not on curve")
    neg_y = (bn.P - y) % bn.P
    y_small, y_big = (y, neg_y) if y < neg_y else (neg_y, y)
    return (x, y_big if flag == FLAG_NEGATIVE else y_small)


def uncompressed_to_g1(buf: bytes) -> G1Point:
    """64-byte BE x || y with canonical + on-curve checks (converter.rs:78-88)."""
    if len(buf) != 64:
        raise errors.InvalidXLengthError(len(buf))
    x = fq_from_slice(buf[:32])
    y = fq_from_slice(buf[32:])
    # Reference-parity: the all-zero uncompressed encoding is REJECTED.
    # converter.rs:78-88 feeds (0,0) to AffineG1::new, whose on-curve check
    # (0 != b) errors — uncompressed bytes have no infinity encoding (only
    # the compressed flag bit does). Tested tests/test_serialization.py.
    pt = (x, y)
    if not bn.g1_is_on_curve(pt):
        raise errors.GroupError("G1 point not on curve")
    return pt


def compressed_to_g2(buf: bytes) -> G2Point:
    """Decompress a gnark G2 point; x serialized as x1 || x0, i.e. the
    imaginary coefficient first (converter.rs:113-133)."""
    if len(buf) != 64:
        raise errors.InvalidXLengthError(len(buf))
    x1, flag = deserialize_with_flags(buf[:32])
    if flag == FLAG_INFINITY:
        return None  # documented divergence: reference returns the generator
    x0 = fq_from_bytes_be_mod_order(buf[32:64])
    x = (x0, x1)
    rhs = bn.fq2_add(bn.fq2_mul(bn.fq2_sq(x), x), bn.B_G2)
    y = bn.fq2_sqrt(rhs)
    if y is None:
        raise errors.InvalidPointError("G2 x not on twist curve")
    neg_y = bn.fq2_neg(y)
    if bn.fq2_lexicographically_largest(y):
        y_small, y_big = neg_y, y
    else:
        y_small, y_big = y, neg_y
    return (x, y_big if flag == FLAG_NEGATIVE else y_small)


def uncompressed_to_g2(buf: bytes) -> G2Point:
    """128-byte BE x1 || x0 || y1 || y0 with checks (converter.rs:135-153)."""
    if len(buf) != 128:
        raise errors.InvalidXLengthError(len(buf))
    x1 = fq_from_slice(buf[0:32])
    x0 = fq_from_slice(buf[32:64])
    y1 = fq_from_slice(buf[64:96])
    y0 = fq_from_slice(buf[96:128])
    # Reference-parity: all-zero rejected via the on-curve check, as in
    # converter.rs:135-153 -> AffineG2::new (see uncompressed_to_g1).
    pt = ((x0, x1), (y0, y1))
    if not bn.g2_is_on_curve(pt):
        raise errors.GroupError("G2 point not on twist curve")
    return pt


def g1_to_bytes(pt: G1Point) -> bytes:
    """Canonical uncompressed BE x || y (the byte stream bound into the
    Fiat-Shamir transcript; plonk/converter.rs:180-185 semantics)."""
    if pt is None:
        return b"\x00" * 64
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def g1_to_compressed_bytes(pt: G1Point) -> bytes:
    """gnark compressed G1 serialization (inverse of compressed_to_g1)."""
    if pt is None:
        return bytes([FLAG_INFINITY]) + b"\x00" * 31
    x, y = pt
    flag = FLAG_NEGATIVE if y > (bn.P - 1) // 2 else FLAG_POSITIVE
    buf = bytearray(x.to_bytes(32, "big"))
    buf[0] |= flag
    return bytes(buf)


def g2_to_compressed_bytes(pt: G2Point) -> bytes:
    """gnark compressed G2 serialization: flagged x1 || x0."""
    if pt is None:
        return bytes([FLAG_INFINITY]) + b"\x00" * 63
    (x0, x1), y = pt
    flag = FLAG_NEGATIVE if bn.fq2_lexicographically_largest(y) else FLAG_POSITIVE
    buf = bytearray(x1.to_bytes(32, "big") + x0.to_bytes(32, "big"))
    buf[0] |= flag
    return bytes(buf)


def g1_to_uncompressed_bytes(pt: G1Point) -> bytes:
    return g1_to_bytes(pt)


def g2_to_uncompressed_bytes(pt: G2Point) -> bytes:
    if pt is None:
        return b"\x00" * 128
    (x0, x1), (y0, y1) = pt
    return b"".join(v.to_bytes(32, "big") for v in (x1, x0, y1, y0))


# ---------------------------------------------------------------------------
# Groth16 data model + loaders (groth16/converter.rs)
# ---------------------------------------------------------------------------


@dataclass
class Groth16Proof:
    ar: G1Point
    bs: G2Point
    krs: G1Point
    commitments: List[G1Point] = field(default_factory=list)
    commitment_pok: G1Point = None


@dataclass
class Groth16VerifyingKey:
    alpha_g1: G1Point
    beta_g1: G1Point            # negated at load time (groth16/converter.rs:74)
    delta_g1: G1Point
    k: List[G1Point] = field(default_factory=list)
    beta_g2: G2Point = None     # negated at load time (groth16/converter.rs:79)
    gamma_g2: G2Point = None
    delta_g2: G2Point = None
    pedersen_g: G2Point = None
    pedersen_g_root_sigma_neg: G2Point = None
    public_and_commitment_committed: List[List[int]] = field(default_factory=lambda: [[]])


def load_groth16_proof_from_bytes(buf: bytes) -> Groth16Proof:
    """Layout: ar G1 [0..64), bs G2 [64..192), krs G1 [192..256); trailing
    commitment-count/pok bytes are ignored (groth16/converter.rs:14-25)."""
    if len(buf) < 256:
        raise errors.InvalidXLengthError(len(buf))
    return Groth16Proof(
        ar=uncompressed_to_g1(buf[0:64]),
        bs=uncompressed_to_g2(buf[64:192]),
        krs=uncompressed_to_g1(buf[192:256]),
        commitments=[],
        commitment_pok=bn.G1_GEN,
    )


def load_groth16_verifying_key_from_bytes(buf: bytes) -> Groth16VerifyingKey:
    """gnark vk.WriteTo layout (groth16/converter.rs:28-89). The beta points
    are negated here at load time so verify uses them directly."""
    alpha = compressed_to_g1(buf[0:32])
    beta_g1 = compressed_to_g1(buf[32:64])
    beta_g2 = compressed_to_g2(buf[64:128])
    gamma_g2 = compressed_to_g2(buf[128:192])
    delta_g1 = compressed_to_g1(buf[192:224])
    delta_g2 = compressed_to_g2(buf[224:288])
    (num_k,) = struct.unpack_from(">I", buf, 288)
    off = 292
    k = []
    for _ in range(num_k):
        k.append(compressed_to_g1(buf[off : off + 32]))
        off += 32
    # public_and_commitment_committed: lengths parsed only to advance the
    # offset; contents discarded (groth16/converter.rs:47-65,:87)
    (num_arrays,) = struct.unpack_from(">I", buf, off)
    off += 4
    for _ in range(num_arrays):
        (n,) = struct.unpack_from(">I", buf, off)
        off += 4 + 4 * n
    pedersen_g = compressed_to_g2(buf[off : off + 64])
    pedersen_root = compressed_to_g2(buf[off + 64 : off + 128])
    return Groth16VerifyingKey(
        alpha_g1=alpha,
        beta_g1=bn.g1_neg(beta_g1),
        delta_g1=delta_g1,
        k=k,
        beta_g2=bn.g2_neg(beta_g2),
        gamma_g2=gamma_g2,
        delta_g2=delta_g2,
        pedersen_g=pedersen_g,
        pedersen_g_root_sigma_neg=pedersen_root,
        public_and_commitment_committed=[[]],
    )


# ---------------------------------------------------------------------------
# PlonK data model + loaders (plonk/converter.rs)
# ---------------------------------------------------------------------------


@dataclass
class BatchOpeningProof:
    h: G1Point
    claimed_values: List[int]


@dataclass
class OpeningProof:
    h: G1Point
    claimed_value: int


@dataclass
class PlonkProof:
    lro: Tuple[G1Point, G1Point, G1Point]
    z: G1Point
    h: Tuple[G1Point, G1Point, G1Point]
    bsb22_commitments: List[G1Point]
    batched_proof: BatchOpeningProof
    z_shifted_opening: OpeningProof


@dataclass
class KZGVerifyingKey:
    g2: Tuple[G2Point, G2Point]  # [G2, [alpha]G2]
    g1: G1Point


@dataclass
class PlonkVerifyingKey:
    size: int
    size_inv: int
    generator: int
    nb_public_variables: int
    kzg: KZGVerifyingKey
    coset_shift: int
    s: Tuple[G1Point, G1Point, G1Point]
    ql: G1Point
    qr: G1Point
    qm: G1Point
    qo: G1Point
    qk: G1Point
    qcp: List[G1Point]
    commitment_constraint_indexes: List[int]


# gnark's vk.WriteTo embeds 33,788 bytes of precomputed Miller-loop line
# evaluations that the reference (and we) skip: plonk/converter.rs:58
GNARK_PRECOMPUTED_LINES_SIZE = 33788


def load_plonk_verifying_key_from_bytes(buf: bytes) -> PlonkVerifyingKey:
    """gnark PlonK vk.WriteTo layout (plonk/converter.rs:18-119)."""
    (size,) = struct.unpack_from(">Q", buf, 0)
    size_inv = fr_from_slice(buf[8:40])
    generator = fr_from_slice(buf[40:72])
    (nb_public_variables,) = struct.unpack_from(">Q", buf, 72)
    coset_shift = fr_from_slice(buf[80:112])
    pts = [compressed_to_g1(buf[112 + 32 * i : 144 + 32 * i]) for i in range(8)]
    s0, s1, s2, ql, qr, qm, qo, qk = pts
    (num_qcp,) = struct.unpack_from(">I", buf, 368)
    off = 372
    qcp = []
    for _ in range(num_qcp):
        qcp.append(compressed_to_g1(buf[off : off + 32]))
        off += 32
    g1 = compressed_to_g1(buf[off : off + 32])
    g2_0 = compressed_to_g2(buf[off + 32 : off + 96])
    g2_1 = compressed_to_g2(buf[off + 96 : off + 160])
    off += 160 + GNARK_PRECOMPUTED_LINES_SIZE
    (num_cci,) = struct.unpack_from(">Q", buf, off)
    off += 8
    cci = []
    for _ in range(num_cci):
        (idx,) = struct.unpack_from(">Q", buf, off)
        cci.append(idx)
        off += 8
    return PlonkVerifyingKey(
        size=size,
        size_inv=size_inv,
        generator=generator,
        nb_public_variables=nb_public_variables,
        kzg=KZGVerifyingKey(g2=(g2_0, g2_1), g1=g1),
        coset_shift=coset_shift,
        s=(s0, s1, s2),
        ql=ql,
        qr=qr,
        qm=qm,
        qo=qo,
        qk=qk,
        qcp=qcp,
        commitment_constraint_indexes=cci,
    )


def load_plonk_proof_from_bytes(buf: bytes) -> PlonkProof:
    """Raw gnark PlonK proof layout (plonk/converter.rs:121-178)."""
    g1s = [uncompressed_to_g1(buf[64 * i : 64 * (i + 1)]) for i in range(8)]
    lro0, lro1, lro2, z, h0, h1, h2, batched_h = g1s
    (num_claimed,) = struct.unpack_from(">I", buf, 512)
    off = 516
    claimed_values = []
    for _ in range(num_claimed):
        claimed_values.append(fr_from_slice(buf[off : off + 32]))
        off += 32
    z_shifted_h = uncompressed_to_g1(buf[off : off + 64])
    z_shifted_value = fr_from_slice(buf[off + 64 : off + 96])
    (num_bsb22,) = struct.unpack_from(">I", buf, off + 96)
    off += 100
    bsb22 = []
    for _ in range(num_bsb22):
        bsb22.append(uncompressed_to_g1(buf[off : off + 64]))
        off += 64
    return PlonkProof(
        lro=(lro0, lro1, lro2),
        z=z,
        h=(h0, h1, h2),
        bsb22_commitments=bsb22,
        batched_proof=BatchOpeningProof(h=batched_h, claimed_values=claimed_values),
        z_shifted_opening=OpeningProof(h=z_shifted_h, claimed_value=z_shifted_value),
    )

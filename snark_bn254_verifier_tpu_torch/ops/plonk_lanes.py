"""Plain PyTorch twins of kernel K7 (csrc/plonk.cuh), the PlonK batch's
per-lane scalar pass, and the host's part of it.

The JAX package does this pass in Python on the host
(snark_bn254_verifier_tpu/parallel/batch.py:575-600 and :642-733); the port
runs it on the card as K7a (before phase A) and K7b (between the phases),
and these are their twins, vectorised over lanes: the same values, the
same products in the same order (so ``utils/roofline.py`` counts the
card's work on them) and the same SHA-256 compressions. The twins compute
in int64 lanes: PyTorch on the CPU has no uint32 add, shift or compare, so
SHA-256 words are kept below 2^32 by masks.

Host side (numpy, once per batch): ``pack_proofs`` joins the proofs into
one (B, L) byte array and applies the byte checks that need no
arithmetic; ``LanesVk`` holds what K7 reads of a VK, built once per VK,
its words (``LanesVk.blob``) uploaded once per device.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from ..oracle import bn254 as bn
from ..utils import serialization as ser
from . import field as F
from .limbs import FQ, FR, int_to_limbs, int_to_words

_I64 = torch.int64
M32 = 0xFFFFFFFF
BSB22_DST = b"BSB22-Plonk"  # models/plonk.py::BSB22_DST (plonk/verify.rs:140)
HTF_BYTES = 48  # hash_to_field's bytes an element (hash_to_field.rs:31-34)

SHA256_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1, 0x923f82a4,
    0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe,
    0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc, 0x2de92c6f,
    0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
    0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116,
    0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208, 0x90befffa, 0xa4506ceb, 0xbef9a3f7,
    0xc67178f2)
SHA256_IV = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
             0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)


# -- SHA-256 over lanes -------------------------------------------------------

def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def sha256_compress(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One compression: state h (8, B) and block w (16, B) of big-endian
    words, int64 below 2^32; returns the new state (8, B)."""
    w = list(w.unbind(0))
    a, b, c, d, e, f, g, hh = h.unbind(0)
    for t in range(64):
        if t >= 16:
            w15, w2 = w[(t - 15) & 15], w[(t - 2) & 15]
            s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
            s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
            w[t & 15] = (w[t & 15] + s0 + w[(t - 7) & 15] + s1) & M32
        t1 = (hh + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)) + ((e & f) ^ (~e & g))
              + SHA256_K[t] + w[t & 15]) & M32
        t2 = ((_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c))) & M32
        hh, g, f, e, d, c, b, a = g, f, e, (d + t1) & M32, c, b, a, (t1 + t2) & M32
    return (h + torch.stack([a, b, c, d, e, f, g, hh])) & M32


def _words(block: torch.Tensor) -> torch.Tensor:
    """(B, 64) bytes -> (16, B) big-endian words."""
    b = block.to(_I64)
    return ((b[:, 0::4] << 24) | (b[:, 1::4] << 16) | (b[:, 2::4] << 8) | b[:, 3::4]).T


def _state_bytes(h: torch.Tensor) -> torch.Tensor:
    """(8, B) words -> (B, 32) uint8 digest bytes."""
    shifts = torch.tensor([24, 16, 8, 0], dtype=_I64, device=h.device)
    return ((h.T.unsqueeze(-1) >> shifts) & 0xFF).reshape(h.shape[1], 32).to(torch.uint8)


def sha256(msg: torch.Tensor, state=SHA256_IV, prefix: int = 0) -> torch.Tensor:
    """SHA-256 of every row of ``msg`` ((B, n) uint8, one message a lane),
    continued from ``state`` (8 words) reached after ``prefix`` bytes, a
    whole number of blocks; returns (B, 32) uint8 digests."""
    b, n = msg.shape
    dev = msg.device
    bits = (prefix + n) * 8
    pad = (55 - n) % 64
    tail = bytes([0x80]) + bytes(pad) + bits.to_bytes(8, "big")
    padded = torch.cat([msg.to(torch.uint8), const_bytes(tail, b, dev)], 1)
    h = torch.tensor(state, dtype=_I64, device=dev).view(8, 1).expand(8, b)
    for i in range(padded.shape[1] // 64):
        h = sha256_compress(h, _words(padded[:, 64 * i:64 * (i + 1)]))
    return _state_bytes(h)


def sha256_midstate(prefix: bytes):
    """(state, whole, tail): the SHA-256 state after the whole blocks of
    ``prefix`` (its first ``whole`` bytes) and the bytes left over."""
    whole = len(prefix) // 64 * 64
    h = torch.tensor(SHA256_IV, dtype=_I64).view(8, 1)
    data = const_bytes(prefix[:whole], 1, "cpu")
    for i in range(whole // 64):
        h = sha256_compress(h, _words(data[:, 64 * i:64 * (i + 1)]))
    return tuple(int(v) for v in h[:, 0]), whole, prefix[whole:]


def const_bytes(data: bytes, b: int, device) -> torch.Tensor:
    """``data`` as a (b, len) uint8 tensor, the same row on every lane."""
    row = torch.tensor(list(data), dtype=torch.uint8, device=device)
    return row.view(1, len(data)).expand(b, len(data))


@functools.lru_cache(maxsize=None)
def _z_pad_state():
    """The state after expand_msg_xmd's Z_pad, one block of zero bytes."""
    return sha256_midstate(bytes(64))[0]


def expand_msg_xmd(msg: torch.Tensor, dst: bytes, length: int) -> torch.Tensor:
    """RFC 9380 expand_message_xmd with SHA-256 (utils/hash_to_field.py)
    over the rows of ``msg`` ((B, n) uint8), b_0 continued from the Z_pad
    block's state as the kernel does; returns (B, length) uint8."""
    b, dev = msg.shape[0], msg.device
    ell = (length + 31) // 32
    dst_prime = const_bytes(dst + bytes([len(dst)]), b, dev)
    b0 = sha256(torch.cat([msg, const_bytes(bytes([length >> 8, length & 0xFF, 0]), b, dev),
                           dst_prime], 1), _z_pad_state(), 64)
    bi = sha256(torch.cat([b0, const_bytes(b"\x01", b, dev), dst_prime], 1))
    out = [bi]
    for i in range(2, ell + 1):
        bi = sha256(torch.cat([b0 ^ bi, const_bytes(bytes([i]), b, dev), dst_prime], 1))
        out.append(bi)
    return torch.cat(out, 1)[:, :length]


# -- bytes and limbs ----------------------------------------------------------

def be_to_limbs(b: torch.Tensor) -> torch.Tensor:
    """(B, 32) big-endian bytes -> (16, B) int64 16-bit limbs."""
    f = b.to(_I64).flip(1)  # little-endian bytes
    return (f[:, 0::2] | (f[:, 1::2] << 8)).T


def limbs_to_be(x: torch.Tensor) -> torch.Tensor:
    """(16, B) limbs -> (B, 32) uint8 big-endian bytes."""
    x = x.to(_I64).T
    out = torch.empty((x.shape[0], 32), dtype=_I64, device=x.device)
    out[:, 0::2] = x & 0xFF
    out[:, 1::2] = x >> 8
    return out.flip(1).to(torch.uint8)


def _limbs(v: int, device) -> torch.Tensor:
    """A constant as (16, 1) int64 limbs."""
    return torch.as_tensor(int_to_limbs(v), dtype=_I64, device=device).view(16, 1)


def _lt(x: torch.Tensor, modulus: int) -> torch.Tensor:
    """x < modulus per lane, x (16, B) limbs below 2^256."""
    return F._sub_raw(x, _limbs(modulus, x.device))[1] == 1


def _mul(spec, a, b):
    return F.mont_mul(spec, a, b)  # looked up per call: roofline counts it


def _to_mont(spec, v):
    """Any 256-bit value (16, B) to Montgomery form mod the spec's modulus."""
    return _mul(spec, v, _limbs(spec.r2, v.device))


def _from_mont(spec, m):
    return _mul(spec, m, _limbs(1, m.device))


def _select(ok: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v where the lane is ok, zero elsewhere; v (..., B)."""
    return torch.where(ok, v, torch.zeros_like(v))


# -- the VK's part, the host's part --------------------------------------------

def proof_bytes(nb: int) -> int:
    """gnark's PlonK proof length with nb BSB22 commitments
    (utils/serialization.py::load_plonk_proof_from_bytes)."""
    return 516 + 32 * (6 + nb) + 100 + 64 * nb


def _off_zs(nb: int) -> int:  # the shifted opening's h, then its value
    return 516 + 32 * (6 + nb)


def _off_cmt(nb: int) -> int:  # the BSB22 commitments
    return _off_zs(nb) + 100


def row_offset(j: int, nb: int) -> int:
    """Byte offset of K2's point row j: cmt_0..cmt_{nb-1}, l, r, o, z, h0,
    h1, h2, the batched opening's h, the shifted opening's h."""
    if j < nb:
        return _off_cmt(nb) + 64 * j
    return 64 * (j - nb) if j - nb < 8 else _off_zs(nb)


class LanesVk:
    """What K7 reads of a PlonK VK, built once per VK on the host: the
    gamma transcript's SHA-256 state after "gamma" and the VK's points
    (s0, s1, s2, ql, qr, qm, qo, qk, qcp: bind_public_data), the bytes of
    that prefix left over, the state after expand_msg_xmd's zero block,
    the Fr constants, and the fold's VK digests (s0, s1, qcp). ``blob``
    lays them out as csrc/plonk.cuh's PV_* words."""

    def __init__(self, vk: ser.PlonkVerifyingKey):
        self.nb_pub = vk.nb_public_variables
        self.nb = len(vk.qcp)
        if len(vk.commitment_constraint_indexes) != self.nb:
            raise ValueError("one commitment constraint index per BSB22 commitment")
        self.size = vk.size
        self.proof_len = proof_bytes(self.nb)
        prefix = b"gamma" + b"".join(
            ser.g1_to_bytes(pt) for pt in (*vk.s, vk.ql, vk.qr, vk.qm, vk.qo, vk.qk, *vk.qcp))
        self.mid, self.mid_bytes, self.tail = sha256_midstate(prefix)
        self.htf_mid = _z_pad_state()
        self.size_inv, self.generator, self.coset_shift = vk.size_inv, vk.generator, vk.coset_shift
        self.w_pows = tuple(pow(vk.generator, j, bn.R) for j in range(self.nb_pub))
        self.cci_wpow = tuple(pow(vk.generator, self.nb_pub + cci, bn.R)
                              for cci in vk.commitment_constraint_indexes)
        self.digests = b"".join(ser.g1_to_bytes(pt) for pt in (vk.s[0], vk.s[1], *vk.qcp))
        self._words = {}

    def fr_consts(self) -> list:
        """The Fr constants in PVF_* order, canonical."""
        return [self.size_inv, self.generator, self.coset_shift, *self.w_pows, *self.cci_wpow]

    def blob(self) -> np.ndarray:
        words = [self.nb_pub, self.nb, self.mid_bytes, len(self.tail), self.size & M32,
                 self.size >> 32, *self.mid]
        words += np.frombuffer(self.tail.ljust(64, b"\0"), "<u4").tolist()
        words += list(self.htf_mid)
        for v in self.fr_consts():
            words += int_to_words(FR.to_mont_int(v))
        words += np.frombuffer(self.digests, "<u4").tolist()
        return np.asarray(words, dtype=np.uint32)

    def words(self, device) -> torch.Tensor:
        """The blob on ``device`` as int32 words (torch has no uint32
        kernels to need), uploaded once a device."""
        key = str(device)
        if key not in self._words:
            self._words[key] = torch.as_tensor(self.blob().view(np.int32), device=device)
        return self._words[key]


def pack_proofs(proofs: Sequence[bytes], vk: LanesVk):
    """The proofs as one (B, L) uint8 array, L = vk.proof_len (a longer
    proof cut to L: the loader ignores trailing bytes), and (B,) bools:
    False where a proof is shorter than L, or its count of claimed values
    (offset 512) is not 6 + nb, or its count of commitments is not nb.
    Those rows are zero."""
    b, length = len(proofs), vk.proof_len
    lens = np.fromiter(map(len, proofs), dtype=np.int64, count=b)
    if b and (lens == length).all():
        raw = np.frombuffer(b"".join(proofs), dtype=np.uint8).reshape(b, length).copy()
    else:
        raw = np.zeros((b, length), dtype=np.uint8)
        for i in np.flatnonzero(lens >= length):
            raw[i] = np.frombuffer(proofs[i], dtype=np.uint8, count=length)
    valid = lens >= length
    be32 = np.array([1 << 24, 1 << 16, 1 << 8, 1], dtype=np.int64)
    n_claimed = raw[:, 512:516].astype(np.int64) @ be32
    off = _off_zs(vk.nb) + 96
    n_cmt = raw[:, off:off + 4].astype(np.int64) @ be32
    valid &= (n_claimed == 6 + vk.nb) & (n_cmt == vk.nb)
    raw[~valid] = 0
    return raw, valid


# -- the lane passes --------------------------------------------------------

def plonk_lanes_a_plain(raw, pub, valid, vk: LanesVk):
    """K7a's twin. raw (B, L) uint8, pub (nb_pub, 16, B) canonical Fr limbs,
    valid (B,) bool (the host's checks). Returns (valid (B,) bool, zeta
    (16, B) canonical, (px, py (m, 16, B) Montgomery, pinf (m, B) bool)
    for K2's m = nb + 9 point rows, lin (nb + 10, 16, B) canonical), every
    output zero (a point at infinity) where the lane fails: a point not
    canonical or off the curve (serialization.py:54-61, :113-126), a
    claimed value not below r, zeta on the domain, or the early check of
    the linearisation constant (OpeningPolyMismatchError)."""
    dev, b = raw.device, raw.shape[0]
    nb, nb_pub = vk.nb, vk.nb_pub
    m = nb + 9

    def at(off, n):
        return raw[:, off:off + n]

    def mulq(a, c):
        return _mul(FQ, a, c)

    def mul(a, c):
        return _mul(FR, a, c)

    ok = valid.to(torch.bool).clone()
    xs, ys = [], []
    b3 = _limbs(FQ.to_mont_int(bn.B_G1), dev)
    for j in range(m):
        off = row_offset(j, nb)
        x, y = be_to_limbs(at(off, 32)), be_to_limbs(at(off + 32, 32))
        canon = _lt(x, bn.P) & _lt(y, bn.P)
        xm, ym = _to_mont(FQ, x), _to_mont(FQ, y)
        t = F.add(FQ, mulq(mulq(xm, xm), xm), b3)
        ok &= canon & F.eq(t, mulq(ym, ym))
        xs.append(xm)
        ys.append(ym)

    # gamma from the VK's midstate; beta, alpha, zeta chained on raw digests
    pub_be = [limbs_to_be(pub[j]) for j in range(nb_pub)]
    dg = sha256(torch.cat([const_bytes(vk.tail, b, dev), *pub_be, at(0, 192)], 1),
                vk.mid, vk.mid_bytes)
    db = sha256(torch.cat([const_bytes(b"beta", b, dev), dg], 1))
    da = sha256(torch.cat([const_bytes(b"alpha", b, dev), db, at(_off_cmt(nb), 64 * nb),
                           at(192, 64)], 1))
    dz = sha256(torch.cat([const_bytes(b"zeta", b, dev), da, at(256, 192)], 1))
    gamma, beta, alpha, zeta = (_to_mont(FR, be_to_limbs(d)) for d in (dg, db, da, dz))

    def frc(v):
        return _limbs(FR.to_mont_int(v), dev)

    one = frc(1)
    zn = F.pow_const(FR, zeta, vk.size)
    zh = F.sub(FR, zn, one)
    zs = mul(zh, frc(vk.size_inv))
    terms = []
    for j, w in enumerate(vk.w_pows + vk.cci_wpow):
        wm = frc(w)
        if j < nb_pub:
            x = _to_mont(FR, pub[j].to(_I64))
        else:
            x = hash_to_fr(at(_off_cmt(nb) + 64 * (j - nb_pub), 64))
        terms.append((mul(mul(zs, wm), x), F.sub(FR, zeta, wm)))
    l1, pi, zero = lagrange_sums(zs, F.sub(FR, zeta, one), terms)
    ok &= ~zero

    cv = [be_to_limbs(at(516 + 32 * i, 32)) for i in range(6 + nb)]
    zu = be_to_limbs(at(_off_zs(nb) + 64, 32))
    for v in cv + [zu]:
        ok &= _lt(v, bn.R)
    cv0m, lm, rm, om, s1m, s2m = (_to_mont(FR, v) for v in cv[:6])
    zum = _to_mont(FR, zu)

    asl1 = mul(mul(l1, alpha), alpha)
    f1 = F.add(FR, F.add(FR, mul(beta, s1m), gamma), lm)
    f2 = F.add(FR, F.add(FR, mul(beta, s2m), gamma), rm)
    f3 = F.add(FR, om, gamma)
    p12 = mul(f1, f2)
    cl = mul(mul(mul(p12, f3), alpha), zum)
    cl = F.neg(FR, F.add(FR, F.sub(FR, cl, asl1), pi))
    ok &= F.eq(cl, cv0m)

    s1v = mul(mul(mul(p12, beta), alpha), zum)
    u = frc(vk.coset_shift)
    g1 = F.add(FR, F.add(FR, mul(beta, zeta), gamma), lm)
    bu = mul(beta, u)
    g2 = F.add(FR, F.add(FR, mul(bu, zeta), gamma), rm)
    bu = mul(bu, u)
    g3 = F.add(FR, F.add(FR, mul(bu, zeta), gamma), om)
    s2v = F.neg(FR, mul(mul(mul(g1, g2), g3), alpha))
    coeff_z = F.add(FR, asl1, s2v)
    rl = mul(lm, rm)
    zn2 = mul(mul(zn, zeta), zeta)
    zn2_zh = F.neg(FR, mul(zn2, zh))
    zn2sq_zh = F.neg(FR, mul(mul(zn2, zn2), zh))
    zh_neg = F.neg(FR, zh)

    z_c = _from_mont(FR, zeta)
    plain_one = _limbs(1, dev).expand_as(zeta)
    cols = cv[6:] + [cv[1], cv[2], _from_mont(FR, rl), cv[3], plain_one,
                     *(_from_mont(FR, v) for v in (s1v, coeff_z, zh_neg, zn2_zh, zn2sq_zh))]
    lin = _select(ok, torch.stack(cols)).to(torch.int32)
    points = (_select(ok, torch.stack(xs)).to(torch.int32),
              _select(ok, torch.stack(ys)).to(torch.int32),
              (~ok).view(1, b).expand(m, b).contiguous())
    return ok, _select(ok, z_c).to(torch.int32), points, lin


def lagrange_sums(zs, d0, terms):
    """K7a's L1 and PI with one inversion a lane: zs / d0 and the sum of
    a / d over ``terms`` ((a, d) pairs), every operand (16, B) Montgomery,
    the terms summed as one fraction; and (B,) True where a denominator is
    zero (the JAX verifier's _batch_inv_mod_r gives None there and the
    lane fails), the sums then meaningless."""
    num = torch.zeros_like(d0)
    den = _limbs(FR.to_mont_int(1), d0.device).expand_as(d0)
    zero = F.is_zero(d0)
    for a, d in terms:
        zero |= F.is_zero(d)
        num = F.add(FR, _mul(FR, num, d), _mul(FR, a, den))
        den = _mul(FR, den, d)
    inv = F.inv(FR, _mul(FR, d0, den))
    return _mul(FR, _mul(FR, zs, den), inv), _mul(FR, _mul(FR, num, d0), inv), zero


def hash_to_fr(cmt: torch.Tensor) -> torch.Tensor:
    """BSB22's hash of (B, 64) commitment bytes to Fr, Montgomery form: the
    48 bytes of expand_msg_xmd as hi 2^256 + lo, lo R^2 + hi R^3."""
    h = expand_msg_xmd(cmt, BSB22_DST, HTF_BYTES)
    lo = be_to_limbs(h[:, 16:48])
    hi = be_to_limbs(torch.cat([torch.zeros_like(h[:, :16]), h[:, :16]], 1))
    r3 = _limbs(pow(2, 768, bn.R), cmt.device)
    return F.add(FR, _to_mont(FR, lo), _mul(FR, hi, r3))


def plonk_lanes_b_plain(raw, valid, zeta, rand, digest, vk: LanesVk):
    """K7b's twin. raw as K7a's; valid (B,) and zeta (16, B) canonical from
    K7a; rand (16, B) the lanes' canonical randomisers; digest phase A's
    (x, y (16, B) Montgomery, inf (B,)). Returns (6 + nb + 6, 16, B)
    canonical scalars: gamma^i for the fold's digests (lin, l, r, o, s0,
    s1, qcp), r, -(folded evaluation + r zu), zeta, r zeta w (the combo
    MSM), then 1, r (the quotient MSM); zero on a lane not valid."""
    dev, b = raw.device, raw.shape[0]
    nb = vk.nb
    ncv = 6 + nb

    def at(off, n):
        return raw[:, off:off + n]

    def mul(a, c):
        return _mul(FR, a, c)

    dx, dy, dinf = digest
    inf = dinf.to(torch.bool)
    x = _select(~inf, _from_mont(FQ, dx.to(_I64)))
    y = _select(~inf, _from_mont(FQ, dy.to(_I64)))
    zc = zeta.to(_I64)
    msg = torch.cat([const_bytes(b"gamma", b, dev), limbs_to_be(zc), limbs_to_be(x),
                     limbs_to_be(y), at(0, 192), const_bytes(vk.digests, b, dev),
                     at(516, 32 * ncv), at(_off_zs(nb) + 64, 32)], 1)
    gam = _to_mont(FR, be_to_limbs(sha256(msg)))

    g = _limbs(FR.r_mod, dev).expand_as(zc)
    folded = _to_mont(FR, be_to_limbs(at(516, 32)))
    rows = [_limbs(1, dev).expand_as(zc)]
    for i in range(1, ncv):
        g = mul(g, gam)
        rows.append(_from_mont(FR, g))
        folded = F.add(FR, folded, mul(_to_mont(FR, be_to_limbs(at(516 + 32 * i, 32))), g))
    rc = rand.to(_I64)
    rm = _to_mont(FR, rc)
    zum = _to_mont(FR, be_to_limbs(at(_off_zs(nb) + 64, 32)))
    fe = _from_mont(FR, F.neg(FR, F.add(FR, folded, mul(rm, zum))))
    rs = _from_mont(FR, mul(mul(_to_mont(FR, zc), _limbs(FR.to_mont_int(vk.generator), dev)),
                            rm))
    rows += [rc, fe, zc, rs, _limbs(1, dev).expand_as(zc), rc]
    return _select(valid.to(torch.bool), torch.stack(rows)).to(torch.int32)


__all__ = ["LanesVk", "pack_proofs", "plonk_lanes_a_plain", "lagrange_sums",
           "plonk_lanes_b_plain", "sha256", "sha256_compress", "sha256_midstate",
           "expand_msg_xmd", "hash_to_fr", "proof_bytes", "row_offset"]

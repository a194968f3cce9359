"""PlonK proofs with gnark's byte layout and BSB22 commitments, valid by
construction.

One VK a seed with the configuration's shape (domain size, its generator
and inverse, public-input count, coset shift, BSB22 constraint indexes):
its digests and the SRS secret tau are a trapdoor, every point a known
multiple of a generator. A proof draws fresh commitments, runs the
verifier's own transcript over their bytes to get gamma, beta, alpha and
zeta, picks the claimed evaluations, sets claimed value 0 to the
linearisation constant the verifier recomputes, folds as the verifier
folds, and makes both KZG quotients as (d - y) / (tau - z). So each proof
passes every check, BSB22's hash to field included.

Fault kinds (each on a proof of its own): ``opening_doubled`` and
``shifted_doubled`` (a KZG quotient doubled: only the pairing rejects
it), ``wrong_value`` (input 0 plus one), ``claimed0`` (claimed value 0
changed: the linearisation check), ``truncated`` (the proof cut at 600
bytes), ``other_statement`` (a valid proof of other inputs),
``wrong_count`` (an input dropped), ``extra_claimed`` (one claimed value
too many), ``noncanonical_x`` (L.x plus p), ``claimed_ge_r`` (claimed
value 1 plus r), ``off_curve`` (H0.y plus one).
"""

from __future__ import annotations

import random
import struct

from ..reference import bn254 as bn
from ..reference import codec
from ..reference.transcript import Transcript, hash_to_fr
from .fixed_base import tables

R = bn.R
BSB22_DST = b"BSB22-Plonk"
KINDS = ("opening_doubled", "shifted_doubled", "wrong_value", "claimed0", "truncated",
         "other_statement", "wrong_count", "extra_claimed", "noncanonical_x", "claimed_ge_r",
         "off_curve")
DIGESTS = ("s0", "s1", "s2", "ql", "qr", "qm", "qo", "qk")


def _fr(rng: random.Random) -> int:
    return rng.randrange(1, R - 1)


def _inv(v: int) -> int:
    return pow(v % R, -1, R)


class PlonkGen:
    """A trapdoor VK of the configuration's shape from ``rng``, and proofs
    under it."""

    def __init__(self, cfg: dict, rng: random.Random):
        g1, g2 = tables()
        self.g1, self.rng = g1.mul, rng
        self.n = cfg["domain_size"]
        self.omega = cfg["domain_generator"]
        self.size_inv = cfg["domain_size_inv"]
        self.nb_pub = cfg["num_public_inputs"]
        self.shift = cfg["coset_shift"]
        self.cci = cfg["bsb22_constraint_indexes"]
        if self.size_inv * self.n % R != 1 or pow(self.omega, self.n, R) != 1:
            raise ValueError(f"{cfg['name']}: not a domain of size {self.n}")
        self.tau = _fr(rng)
        self.d = {name: _fr(rng) for name in DIGESTS}
        self.qcp = [_fr(rng) for _ in self.cci]
        self.pt = {name: codec.g1_bytes(self.g1(v)) for name, v in self.d.items()}
        self.qcp_bytes = [codec.g1_bytes(self.g1(v)) for v in self.qcp]
        self.vk_binding = [self.pt[name] for name in DIGESTS] + self.qcp_bytes
        c1 = codec.g1_compressed_bytes
        vk = [struct.pack(">Q", self.n), codec.fr_bytes(self.size_inv),
              codec.fr_bytes(self.omega), struct.pack(">Q", self.nb_pub),
              codec.fr_bytes(self.shift)]
        vk += [c1(self.g1(self.d[name])) for name in DIGESTS]
        vk.append(struct.pack(">I", len(self.qcp)))
        vk += [c1(self.g1(v)) for v in self.qcp]
        vk += [c1(bn.G1_GEN), codec.g2_compressed_bytes(bn.G2_GEN),
               codec.g2_compressed_bytes(g2.mul(self.tau)), bytes(codec.PLONK_VK_LINES_BYTES),
               struct.pack(f">Q{len(self.cci)}Q", len(self.cci), *self.cci)]
        self.vk = b"".join(vk)
        # the Lagrange points of the inputs and of the BSB22 constraints
        self.w_pub = [pow(self.omega, i, R) for i in range(self.nb_pub)]
        self.w_cci = [pow(self.omega, self.nb_pub + c, R) for c in self.cci]

    def inputs(self) -> list:
        return [_fr(self.rng) for _ in range(self.nb_pub)]

    def proof(self, inputs) -> bytes:
        rng, g1, R_ = self.rng, self.g1, R
        nb = len(self.cci)
        lro = [_fr(rng) for _ in range(3)]
        zd = _fr(rng)
        hq = [_fr(rng) for _ in range(3)]
        bsb = [_fr(rng) for _ in range(nb)]
        lro_b = [codec.g1_bytes(g1(v)) for v in lro]
        z_b = codec.g1_bytes(g1(zd))
        hq_b = [codec.g1_bytes(g1(v)) for v in hq]
        bsb_b = [codec.g1_bytes(g1(v)) for v in bsb]

        fs = Transcript("gamma", "beta", "alpha", "zeta")
        for data in self.vk_binding + [codec.fr_bytes(w) for w in inputs] + lro_b:
            fs.bind("gamma", data)
        gamma, beta = fs.challenge("gamma"), fs.challenge("beta")
        for data in bsb_b + [z_b]:
            fs.bind("alpha", data)
        alpha = fs.challenge("alpha")
        for data in hq_b:
            fs.bind("zeta", data)
        zeta = fs.challenge("zeta")

        n, s_inv = self.n, self.size_inv
        zh = (pow(zeta, n, R_) - 1) % R_
        l1 = zh * _inv(zeta - 1) % R_ * s_inv % R_
        pi = sum(zh * _inv(zeta - wi) % R_ * s_inv % R_ * wi % R_ * w
                 for wi, w in zip(self.w_pub, inputs))
        pi += sum(zh * wi % R_ * _inv(zeta - wi) % R_ * s_inv % R_ * hash_to_fr(cb, BSB22_DST)
                  for wi, cb in zip(self.w_cci, bsb_b))
        pi %= R_

        l, r, o, s1v, s2v, zu = (_fr(rng) for _ in range(6))
        qcp_evals = [_fr(rng) for _ in range(nb)]
        a2l1 = l1 * alpha % R_ * alpha % R_
        const = (beta * s1v + gamma + l) * (beta * s2v + gamma + r) % R_ * (o + gamma) % R_
        const = (-(const * alpha % R_ * zu - a2l1 + pi)) % R_
        claimed = [const, l, r, o, s1v, s2v] + qcp_evals

        c_s1 = (beta * s1v + l + gamma) * (beta * s2v + r + gamma) % R_ * beta % R_ * alpha % R_ * zu
        u = self.shift
        c_s2 = (beta * zeta + gamma + l) * (beta * u * zeta + gamma + r) % R_
        c_s2 = -(c_s2 * (beta * u * u * zeta + gamma + o) % R_ * alpha)
        zn2 = pow(zeta, n + 2, R_)
        d = self.d
        lin = sum(p * s for p, s in zip(
            bsb + [d["ql"], d["qr"], d["qm"], d["qo"], d["qk"], d["s2"], zd] + hq,
            qcp_evals + [l, r, l * r, o, 1, c_s1, a2l1 + c_s2, -zh, -zn2 * zh,
                         -zn2 * zn2 % R_ * zh])) % R_

        fold_dlogs = [lin] + lro + [d["s0"], d["s1"]] + self.qcp
        tr = Transcript("gamma")
        tr.bind("gamma", codec.fr_bytes(zeta))
        for data in [codec.g1_bytes(g1(lin))] + lro_b + [self.pt["s0"], self.pt["s1"]] \
                + self.qcp_bytes:
            tr.bind("gamma", data)
        for v in claimed + [zu]:
            tr.bind("gamma", codec.fr_bytes(v))
        fold = tr.challenge("gamma")
        fd, fe, gp = 0, 0, 1
        for dl, v in zip(fold_dlogs, claimed):
            fd, fe, gp = fd + dl * gp, fe + v * gp, gp * fold % R_
        hb = (fd - fe) * _inv(self.tau - zeta) % R_
        hz = (zd - zu) * _inv(self.tau - zeta * self.omega) % R_

        out = lro_b + [z_b] + hq_b + [codec.g1_bytes(g1(hb)), struct.pack(">I", len(claimed))]
        out += [codec.fr_bytes(v) for v in claimed]
        out += [codec.g1_bytes(g1(hz)), codec.fr_bytes(zu), struct.pack(">I", nb)] + bsb_b
        return b"".join(out)

    def bad(self, kind: str, proof: bytes, inputs: list):
        """(proof, inputs) of fault ``kind`` made from a valid pair."""
        n_claimed = struct.unpack_from(">I", proof, 512)[0]
        shifted = 516 + 32 * n_claimed
        if kind == "opening_doubled":
            return _double_at(proof, 7 * 64), inputs
        if kind == "shifted_doubled":
            return _double_at(proof, shifted), inputs
        if kind == "wrong_value":
            return proof, [inputs[0] + 1] + inputs[1:]
        if kind == "claimed0":
            return proof[:547] + bytes([proof[547] ^ 1]) + proof[548:], inputs
        if kind == "truncated":
            return proof[:600], inputs
        if kind == "other_statement":
            return self.proof(self.inputs()), inputs
        if kind == "wrong_count":
            return proof, inputs[:-1]
        if kind == "extra_claimed":
            return (proof[:512] + struct.pack(">I", n_claimed + 1) + proof[516:shifted]
                    + proof[516:548] + proof[shifted:]), inputs
        if kind == "noncanonical_x":
            return _add_at(proof, 0, bn.P), inputs
        if kind == "claimed_ge_r":
            return _add_at(proof, 516 + 32, R), inputs
        if kind == "off_curve":
            return _add_at(proof, 4 * 64 + 32, 1), inputs
        raise ValueError(f"unknown PlonK fault kind {kind!r}")


def _double_at(proof: bytes, off: int) -> bytes:
    pt = codec.g1(proof[off:off + 64])
    return proof[:off] + codec.g1_bytes(bn.g1_add(pt, pt)) + proof[off + 64:]


def _add_at(proof: bytes, off: int, add: int) -> bytes:
    """The 32-byte big-endian value at ``off`` plus ``add``."""
    v = int.from_bytes(proof[off:off + 32], "big") + add
    return proof[:off] + v.to_bytes(32, "big") + proof[off + 32:]

"""Plain PlonK verification over BN254 with BSB22 commitments
(verifier/src/plonk/{verify,kzg}.rs of snark-bn254-verifier, gnark's
backend/plonk/bn254), the reference the benchmark holds the port's PlonK
verdicts against.

A proof verifies iff its bytes parse (codec.plonk_proof: canonical, on
the curve), its BSB22 commitments and the inputs match the VK's counts,
the linearisation constant the verifier recomputes equals claimed value
0, there are as many claimed values as digests to fold, and the KZG
batch opening of the folded digest at zeta and of Z at zeta * omega
holds. The two openings are checked together under a random combination
(1, rho): the caller passes rho, so the verdict is the same on every run.
"""

from __future__ import annotations

import random
from typing import Sequence

from . import bn254 as bn
from . import codec
from .transcript import Transcript, hash_to_fr

R = bn.R
BSB22_DST = b"BSB22-Plonk"


def _msm(points, scalars):
    acc = None
    for p, s in zip(points, scalars):
        acc = bn.g1_add(acc, bn.g1_mul(p, s % R))
    return acc


class PlonkReference:
    """One VK, parsed once."""

    def __init__(self, vk_bytes: bytes):
        self.vk = codec.plonk_vk(vk_bytes)

    def verify(self, proof: bytes, inputs: Sequence[int], rho: int,
               canonical: bool = True) -> bool:
        try:
            pr = codec.plonk_proof(proof, canonical)
        except codec.Reject:
            return False
        return self._equations(pr, inputs, rho)

    def _equations(self, pr: codec.PlonkProof, inputs: Sequence[int], rho: int) -> bool:
        vk = self.vk
        nb = len(vk.qcp)
        if len(pr.bsb22) != nb or len(inputs) != vk.nb_pub:
            return False
        g = codec.g1_bytes
        fs = Transcript("gamma", "beta", "alpha", "zeta")
        for pt in (*vk.s, vk.ql, vk.qr, vk.qm, vk.qo, vk.qk, *vk.qcp):
            fs.bind("gamma", g(pt))
        for w in inputs:
            fs.bind("gamma", codec.fr_bytes(w))
        for pt in pr.lro:
            fs.bind("gamma", g(pt))
        gamma = fs.challenge("gamma")
        beta = fs.challenge("beta")
        for pt in (*pr.bsb22, pr.z):
            fs.bind("alpha", g(pt))
        alpha = fs.challenge("alpha")
        for pt in pr.h:
            fs.bind("zeta", g(pt))
        zeta = fs.challenge("zeta")
        if zeta == 1:
            return False

        n = vk.size
        zh = (pow(zeta, n, R) - 1) % R
        lagrange_one = zh * pow(zeta - 1, -1, R) % R * vk.size_inv % R
        pi, wi = 0, 1
        for w in inputs:
            if zeta == wi:
                return False
            pi += zh * pow(zeta - wi, -1, R) % R * vk.size_inv % R * wi % R * (w % R)
            wi = wi * vk.omega % R
        for cmt, ci in zip(pr.bsb22, vk.cci):
            w_i = pow(vk.omega, vk.nb_pub + ci, R)
            if zeta == w_i:
                return False
            lag = zh * w_i % R * pow(zeta - w_i, -1, R) % R * vk.size_inv % R
            pi += lag * hash_to_fr(g(cmt), BSB22_DST)
        pi %= R

        cv = pr.claimed
        if len(cv) < 6 + nb:
            return False
        l, r, o, s1, s2 = cv[1:6]
        zu = pr.shifted_value
        a2l1 = lagrange_one * alpha % R * alpha % R
        const = (beta * s1 + gamma + l) * (beta * s2 + gamma + r) % R * (o + gamma) % R
        const = (-(const * alpha % R * zu % R - a2l1 + pi)) % R
        if const != cv[0]:
            return False

        u = vk.coset_shift
        c_s1 = (beta * s1 + l + gamma) * (beta * s2 + r + gamma) % R * beta % R * alpha % R * zu
        c_s2 = (beta * zeta + gamma + l) * (beta * u * zeta + gamma + r) % R
        c_s2 = -(c_s2 * (beta * u * u * zeta + gamma + o) % R * alpha)
        zn2 = pow(zeta, n + 2, R)
        lin = _msm([*pr.bsb22, vk.ql, vk.qr, vk.qm, vk.qo, vk.qk, vk.s[2], pr.z, *pr.h],
                   [*cv[6:6 + nb], l, r, l * r, o, 1, c_s1, a2l1 + c_s2, -zh, -zn2 * zh,
                    -zn2 * zn2 % R * zh])

        digests = [lin, *pr.lro, vk.s[0], vk.s[1], *vk.qcp]
        if len(digests) != len(cv):
            return False
        tr = Transcript("gamma")
        tr.bind("gamma", codec.fr_bytes(zeta))
        for d in digests:
            tr.bind("gamma", g(d))
        for v in cv:
            tr.bind("gamma", codec.fr_bytes(v))
        tr.bind("gamma", codec.fr_bytes(zu))
        fold = tr.challenge("gamma")
        powers = [pow(fold, i, R) for i in range(len(digests))]
        folded_digest = _msm(digests, powers)
        folded_value = sum(v * c for v, c in zip(cv, powers)) % R

        # e(D0 - v0 G + z0 H0 + rho (D1 - v1 G + z1 H1), [1]) * e(-(H0 + rho H1), [tau]) == 1
        z1 = zeta * vk.omega % R
        lhs = _msm([folded_digest, pr.z, vk.kzg_g1, pr.opening_h, pr.shifted_h],
                   [1, rho, -(folded_value + rho * zu), zeta, rho * z1])
        quot = bn.g1_neg(_msm([pr.opening_h, pr.shifted_h], [1, rho]))
        gt = bn.pairing_batch([(lhs, vk.kzg_g2[0]), (quot, vk.kzg_g2[1])])
        return bn.fq12_is_one(gt)


def verifier(vk_bytes: bytes, seed: int):
    """The reference's verdict function for the benchmark's check:
    ``verify(proof, inputs, canonical=True) -> bool``, its opening
    combination rho drawn from ``seed``."""
    ref = PlonkReference(vk_bytes)
    rho = random.Random(f"rho/{seed}").randrange(1, R)
    return lambda proof, inputs, canonical=True: ref.verify(proof, inputs, rho, canonical)

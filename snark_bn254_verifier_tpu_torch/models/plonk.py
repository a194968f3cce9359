"""Single-proof PlonK verification on PyTorch: the reference's public API.

The protocol code (``verify_plonk`` and its helpers) is the port's copy of
the JAX package's models/plonk.py (plonk.py:30-217 there), which mirrors
verifier/src/plonk/verify.rs:46-316 step by step: Fiat-Shamir challenge
derivation (gamma, beta, alpha, zeta), the public-input Lagrange sum with
batch inversion, BSB22 hash-to-field terms, the linearization-constant
early check, the linearized-polynomial digest MSM, KZG proof folding and
the final 2-pairing batch opening check. All Fr scalar algebra is
host-side Python ints; MSMs and pairings go through the compute backend.

The facade ``PlonkVerifier`` is the counterpart of the JAX package's
(plonk.py:220-267 there; reference verifier/src/lib.rs:69): the MSMs run
on kernel K2 and the final two-pair KZG check on K5 + K4, through a
``TorchBackend``. As in the Groth16 facade, there is no batch-1 fast path:
each call runs one pipeline. Protocol failures raise the reference's
errors (``InvalidWitnessError``, ``OpeningPolyMismatchError``,
``PairingCheckFailedError``, ...); a proof that verifies returns True.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

from ..oracle import bn254 as bn
from ..utils import errors
from ..utils import serialization as ser
from ..utils.hash_to_field import WrappedHashToField
from ..utils.transcript import ALPHA, BETA, GAMMA, ZETA, Transcript
from . import kzg
from ..utils.profiling import span
from .backend import facade_backend, get_backend

R = bn.R

BSB22_DST = b"BSB22-Plonk"


def bind_public_data(
    transcript: Transcript,
    challenge: str,
    vk: ser.PlonkVerifyingKey,
    public_inputs: Sequence[int],
) -> None:
    """plonk/verify.rs:319-344: s0..s2, ql..qk, qcp, then the inputs."""
    for pt in (*vk.s, vk.ql, vk.qr, vk.qm, vk.qo, vk.qk):
        transcript.bind(challenge, ser.g1_to_bytes(pt))
    for qcp in vk.qcp:
        transcript.bind(challenge, ser.g1_to_bytes(qcp))
    for public_input in public_inputs:
        transcript.bind(challenge, ser.fr_to_bytes_be(public_input))


def derive_randomness(
    transcript: Transcript,
    challenge: str,
    points: Optional[Sequence[ser.G1Point]] = None,
) -> int:
    """plonk/verify.rs:346-362."""
    if points is not None:
        for point in points:
            transcript.bind(challenge, ser.g1_to_bytes(point))
    return ser.fr_from_bytes_be_mod_order(transcript.compute_challenge(challenge))


def batch_invert(elements: Sequence[int]) -> List[int]:
    """Montgomery-trick batch inversion (plonk/verify.rs:364-396); zero
    entries are left as zero, matching the reference's filter."""
    out = list(elements)
    nonzero_idx = [i for i, e in enumerate(out) if e % R != 0]
    prod = []
    acc = 1
    for i in nonzero_idx:
        acc = acc * out[i] % R
        prod.append(acc)
    if not nonzero_idx:
        return out
    acc = pow(acc, R - 2, R)
    for j in range(len(nonzero_idx) - 1, -1, -1):
        i = nonzero_idx[j]
        prev = prod[j - 1] if j > 0 else 1
        out_i = acc * prev % R
        acc = acc * out[i] % R
        out[i] = out_i
    return out


def verify_plonk(
    vk: ser.PlonkVerifyingKey,
    proof: ser.PlonkProof,
    public_inputs: Sequence[int],
    backend=None,
    rng=None,
) -> bool:
    backend = get_backend(backend)

    if len(proof.bsb22_commitments) != len(vk.qcp):
        raise errors.Bsb22CommitmentMismatchError()
    if len(public_inputs) != vk.nb_public_variables:
        raise errors.InvalidWitnessError()

    # ---- Fiat-Shamir challenges (plonk/verify.rs:62-95) ----
    fs = Transcript([GAMMA, BETA, ALPHA, ZETA])
    bind_public_data(fs, GAMMA, vk, public_inputs)
    gamma = derive_randomness(fs, GAMMA, list(proof.lro))
    beta = derive_randomness(fs, BETA)
    alpha_deps = list(proof.bsb22_commitments) + [proof.z]
    alpha = derive_randomness(fs, ALPHA, alpha_deps)
    zeta = derive_randomness(fs, ZETA, list(proof.h))

    # ---- zh(zeta) and L1(zeta) (plonk/verify.rs:98-108) ----
    n = vk.size
    zeta_power_n = pow(zeta, n, R)
    zh_zeta = (zeta_power_n - 1) % R
    zeta_minus_one = (zeta - 1) % R
    if zeta_minus_one == 0:
        raise errors.InverseNotFoundError()
    lagrange_one = pow(zeta_minus_one, R - 2, R) * zh_zeta % R * vk.size_inv % R

    # ---- PI = sum L_i(zeta) w_i over public inputs (plonk/verify.rs:111-137)
    pi = 0
    if public_inputs:
        dens = []
        accw = 1
        for _ in public_inputs:
            dens.append((zeta - accw) % R)
            accw = accw * vk.generator % R
        inv_dens = batch_invert(dens)
        accw = 1
        for i, w in enumerate(public_inputs):
            xi_li = zh_zeta * inv_dens[i] % R * vk.size_inv % R * accw % R * (w % R) % R
            accw = accw * vk.generator % R
            pi = (pi + xi_li) % R

    # ---- BSB22 commitments (plonk/verify.rs:140-163) ----
    htf = WrappedHashToField(BSB22_DST)
    for i, cci in enumerate(vk.commitment_constraint_indexes):
        htf.write(ser.g1_to_bytes(proof.bsb22_commitments[i]))
        hash_bts = htf.sum()
        htf.reset()
        hashed_cmt = int.from_bytes(hash_bts, "big") % R
        exponent = vk.nb_public_variables + cci
        if exponent >= R:
            raise errors.BeyondTheModulusError()
        w_pow_i = pow(vk.generator, exponent, R)
        den = (zeta - w_pow_i) % R
        if den == 0:
            raise errors.InverseNotFoundError()
        lagrange = zh_zeta * w_pow_i % R * pow(den, R - 2, R) % R * vk.size_inv % R
        pi = (pi + lagrange * hashed_cmt) % R

    # ---- claimed values (plonk/verify.rs:166-177) ----
    cv = proof.batched_proof.claimed_values
    if len(cv) < 6 + len(vk.qcp):
        raise errors.InvalidWitnessError("not enough claimed values")
    l, r_, o, s1, s2 = cv[1], cv[2], cv[3], cv[4], cv[5]
    zu = proof.z_shifted_opening.claimed_value

    alpha_sq_lagrange = lagrange_one * alpha % R * alpha % R

    # ---- linearization constant check (plonk/verify.rs:180-214) ----
    const_lin = (beta * s1 + gamma + l) % R
    const_lin = const_lin * ((beta * s2 + gamma + r_) % R) % R
    const_lin = const_lin * ((o + gamma) % R) % R
    const_lin = const_lin * alpha % R * zu % R
    const_lin = (const_lin - alpha_sq_lagrange + pi) % R
    const_lin = (-const_lin) % R

    if const_lin != cv[0] % R:
        raise errors.OpeningPolyMismatchError()

    # ---- linearized polynomial coefficients (plonk/verify.rs:216-262) ----
    # _s1 = alpha*(l+beta*s1+gamma)*(r+beta*s2+gamma)*beta*zu
    _s1 = (beta * s1 + l + gamma) % R
    _s1 = _s1 * ((beta * s2 + r_ + gamma) % R) % R * beta % R * alpha % R * zu % R
    # _s2 = -alpha*(l+beta*zeta+gamma)*(r+beta*u*zeta+gamma)*(o+beta*u^2*zeta+gamma)
    u = vk.coset_shift
    _s2 = (beta * zeta + gamma + l) % R
    _s2 = _s2 * ((beta * u % R * zeta + gamma + r_) % R) % R
    _s2 = _s2 * ((beta * u % R * u % R * zeta + gamma + o) % R) % R
    _s2 = _s2 * alpha % R
    _s2 = (-_s2) % R
    coeff_z = (alpha_sq_lagrange + _s2) % R
    rl = l * r_ % R

    zeta_n_plus_two = pow(zeta, n + 2, R)
    zeta_n_plus_two_zh = (-(zeta_n_plus_two * zh_zeta)) % R
    zeta_n_plus_two_square_zh = (-(zeta_n_plus_two * zeta_n_plus_two % R * zh_zeta)) % R
    zh = (-zh_zeta) % R

    points = list(proof.bsb22_commitments) + [
        vk.ql, vk.qr, vk.qm, vk.qo, vk.qk, vk.s[2],
        proof.z, proof.h[0], proof.h[1], proof.h[2],
    ]
    qc = [v % R for v in cv[6:]]
    scalars = qc + [
        l, r_, rl, o, 1, _s1, coeff_z, zh,
        zeta_n_plus_two_zh, zeta_n_plus_two_square_zh,
    ]

    linearized_digest = backend.msm(points, scalars)

    # ---- KZG fold + batch opening (plonk/verify.rs:287-309) ----
    digests_to_fold = [
        linearized_digest,
        proof.lro[0], proof.lro[1], proof.lro[2],
        vk.s[0], vk.s[1],
    ] + list(vk.qcp)

    folded_proof, folded_digest = kzg.fold_proof(
        digests_to_fold,
        proof.batched_proof,
        zeta,
        data_transcript=ser.fr_to_bytes_be(zu),
        backend=backend,
    )
    shifted_zeta = zeta * vk.generator % R
    kzg.batch_verify_multi_points(
        [folded_digest, proof.z],
        [folded_proof, proof.z_shifted_opening],
        [zeta, shifted_zeta],
        vk.kzg,
        backend=backend,
        rng=rng,
    )
    return True


class PlonkVerifier:
    """Public API facade. The parsed VK is cached by the sha256 of its
    bytes (it holds no device state)."""

    _vk_cache: dict = {}

    @staticmethod
    def verify(proof: bytes, vk: bytes, public_inputs: Sequence[int], device=None) -> bool:
        """On the torch backend of ``device`` ("cuda" or "cpu") where one
        is named, else on the default backend (models/backend.py): the
        card unless ``set_default_backend`` changed it."""
        with span("bn254.facade.verify"):
            backend = facade_backend(device)
            with span("bn254.facade.parse"):
                key = hashlib.sha256(vk).digest()
                vk_obj = PlonkVerifier._vk_cache.get(key)
                if vk_obj is None:
                    vk_obj = ser.load_plonk_verifying_key_from_bytes(vk)
                    PlonkVerifier._vk_cache[key] = vk_obj
                proof_obj = ser.load_plonk_proof_from_bytes(proof)
            return verify_plonk(vk_obj, proof_obj, public_inputs, backend=backend)

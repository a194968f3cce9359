"""Single-proof Groth16 verification on PyTorch: the reference's public API.

The protocol code (``prepare_inputs``, ``PreparedVerifyingKey``,
``verify_groth16``) is the port's copy of the JAX package's
models/groth16.py (groth16.py:28-82 there; reference
verifier/src/groth16/verify.rs:53-78): the proof is valid iff

    e(ar, bs) * e(sum_i in_i * k_{i+1} + k_0, gamma) * e(krs, -delta)
        == e(alpha, beta)

with the VK's beta points already negated at load time. Pedersen
commitments / commitment_pok are parsed but not verified, as in the
reference.

The facade ``Groth16Verifier`` is the counterpart of the JAX package's
(groth16.py:85-145 there; reference verifier/src/lib.rs:44). It runs the
protocol code on a ``TorchBackend``: one fixed-base MSM call for the
prepared input (kernel msm_fixed, over the window table of k[1:] that the
prepared VK holds), one K5 + K4 call for the three-pair product, each
with one copy back to the host. The JAX facade first tries a batch-1 run
of its batch verifier and falls through to the generic path when that
run fails, a workaround for device round trips over a remote TPU
attachment; here every call runs the one path, so a failing proof pays
once. The error taxonomy is the reference's: ``PrepareInputsFailedError``
for a wrong input count, a parse error for malformed bytes, ``False`` for
a proof that does not verify.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..oracle import bn254 as bn
from ..utils import errors, serialization as ser
from ..utils.profiling import span
from .backend import facade_backend, get_backend


def prepare_inputs(vk: ser.Groth16VerifyingKey, public_inputs: Sequence[int], backend=None,
                   table=None):
    """k[0] + sum_i public_inputs[i] * k[i+1] (groth16/verify.rs:53-63);
    the sum by the backend's fixed-base MSM where given the ``table`` of
    k[1:] that the backend built (``PreparedVerifyingKey.k_table``)."""
    if len(public_inputs) + 1 != len(vk.k):
        raise errors.PrepareInputsFailedError(
            f"got {len(public_inputs)} inputs for {len(vk.k)} k-points"
        )
    backend = get_backend(backend)
    if len(public_inputs) == 0:
        return vk.k[0]
    scalars = [s % bn.R for s in public_inputs]
    if table is not None:
        acc = backend.msm_fixed(table, scalars)
    else:
        acc = backend.msm(vk.k[1:], scalars)
    return bn.g1_add(vk.k[0], acc)


@dataclass
class PreparedVerifyingKey:
    """VK with the constant pairing e(alpha, beta) precomputed once, and
    each backend's window table of k[1:] for its fixed-base MSM: built
    through the backend with the key, and for another backend on its first
    use (None from a backend without one, the oracle)."""

    vk: ser.Groth16VerifyingKey
    alpha_beta: tuple  # Gt (Fq12 element)
    tables: dict = field(default_factory=dict)  # backend -> its table

    @classmethod
    def from_vk(cls, vk: ser.Groth16VerifyingKey, backend=None):
        backend = get_backend(backend)
        prepared = cls(vk=vk, alpha_beta=backend.pairing(vk.alpha_g1, vk.beta_g2))
        prepared.k_table(backend)
        return prepared

    def k_table(self, backend):
        """``backend``'s window table of k[1:], built on its first use."""
        if backend not in self.tables:
            self.tables[backend] = backend.fixed_base_table(self.vk.k[1:])
        return self.tables[backend]

    @classmethod
    def from_bytes(cls, vk_bytes: bytes, backend=None):
        return cls.from_vk(ser.load_groth16_verifying_key_from_bytes(vk_bytes), backend)


def verify_groth16(
    vk: ser.Groth16VerifyingKey,
    proof: ser.Groth16Proof,
    public_inputs: Sequence[int],
    backend=None,
    prepared: Optional[PreparedVerifyingKey] = None,
) -> bool:
    """groth16/verify.rs:65-78 semantics: the product of the three pairings
    against e(alpha, beta), with beta's negation on both sides."""
    backend = get_backend(backend)
    table = prepared.k_table(backend) if prepared is not None else None
    prepared_inputs = prepare_inputs(vk, public_inputs, backend, table)
    alpha_beta = (
        prepared.alpha_beta if prepared is not None else backend.pairing(vk.alpha_g1, vk.beta_g2)
    )
    lhs = backend.pairing_batch(
        [
            (proof.ar, proof.bs),
            (prepared_inputs, vk.gamma_g2),
            (proof.krs, bn.g2_neg(vk.delta_g2)),
        ]
    )
    return lhs == alpha_beta


class Groth16Verifier:
    """Public API facade. The parsed VK and its e(alpha, beta) (computed
    through K5 + K4 on the first call's device) are cached by the sha256 of
    the VK bytes: e(alpha, beta) is a host Fq12 value, the same on every
    device. The prepared VK also holds the window table of k[1:], a
    device tensor of 0.5 MB a point (at most ops/msm.py::FIXED_MAX_POINTS
    points), one for each backend it ran on. So the cache keeps the
    ``CACHE_VKS`` VKs used last and drops the one used longest ago: a
    service that sees many VKs holds at most CACHE_VKS tables a device
    (at most 0.5 GB), and a dropped VK pays its set-up again."""

    CACHE_VKS = 32
    _cache: dict = {}  # insertion order is use order, the newest last

    @staticmethod
    def verify(proof: bytes, vk: bytes, public_inputs: Sequence[int], device=None) -> bool:
        """On the torch backend of ``device`` ("cuda" or "cpu") where one
        is named, else on the default backend (models/backend.py): the
        card unless ``set_default_backend`` changed it."""
        with span("bn254.facade.verify"):
            backend = facade_backend(device)
            with span("bn254.facade.parse"):
                cache = Groth16Verifier._cache
                key = hashlib.sha256(vk).digest()
                ent = cache.get(key)
                vk_obj = ser.load_groth16_verifying_key_from_bytes(vk) if ent is None else ent[0]
                proof_obj = ser.load_groth16_proof_from_bytes(proof)
            if ent is None:  # e(alpha, beta) once per VK, outside the parse
                ent = (vk_obj, PreparedVerifyingKey.from_vk(vk_obj, backend))
                while len(cache) >= Groth16Verifier.CACHE_VKS:
                    del cache[next(iter(cache))]
            else:
                del cache[key]  # put back as the newest
            cache[key] = ent
            return verify_groth16(vk_obj, proof_obj, public_inputs, backend=backend,
                                  prepared=ent[1])

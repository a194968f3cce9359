"""PyTorch compute backend for the protocol verifiers.

The counterpart of snark_bn254_verifier_tpu/models/jax_backend.py
(``JaxBackend``, jax_backend.py:140-197 there), with the OracleBackend
interface of models/backend.py, so the protocol code (``verify_groth16``,
``PreparedVerifyingKey``, ``verify_plonk``) runs on it unchanged. Each primitive packs its host points into limb
tensors on the backend's device, runs its kernels and makes one copy back
to the host:

  msm, g1_mul            ops/msm.py::msm_best at batch one (a point per
                         row): kernel K6 (Pippenger) from 16 points,
                         else kernel K2
  pairing, pairing_batch ops/pairing_cuda.py::pairing_batch: kernel K5
                         over the pairs, then kernel K4
  pairing_batch_is_one   the same, compared with one on the device; one
                         bool comes back

``TorchBackend.instance(device)`` is the one backend a device that
``get_backend("torch")`` (models/backend.py) hands out, as the JAX
package's ``JaxBackend.instance()``.

On a CUDA device every primitive goes through its kernels; a CPU device
runs their plain twins. The MSM switches to Pippenger by
ops/msm.py::use_pippenger, measured on the card (the JAX backend switches
at 64 points, jax_backend.py:113-124 there).
"""

from __future__ import annotations

import torch

from ..ops import msm as M
from ..ops import pairing_cuda as PC
from .packing import pack_g1, pack_g2, pack_msm, pair_major, unpack_fq12, unpack_g1


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class TorchBackend:
    """Device-compute backend on one torch device ("cpu" or "cuda")."""

    name = "torch"
    _instances: dict = {}

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    @classmethod
    def instance(cls, device="cuda") -> "TorchBackend":
        """The shared backend of ``device``, made on first use (which
        raises for "cuda" where there is no card)."""
        key = str(device)
        if key not in cls._instances:
            cls._instances[key] = cls(device)
        return cls._instances[key]

    def _to_dev(self, arrays) -> tuple:
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    # -- MSM ----------------------------------------------------------------

    def msm(self, points, scalars):
        n = len(points)
        if n != len(scalars):
            raise ValueError("one scalar per point")
        if n == 0:
            return None
        pts, sc = pack_msm(points, scalars)
        out = M.msm_best(self._to_dev(pts), torch.as_tensor(sc, device=self.device))
        return unpack_g1(*out)[0]

    def g1_mul(self, point, scalar):
        return self.msm([point], [scalar])

    # -- pairings -----------------------------------------------------------

    def _pairs(self, pairs) -> tuple:
        """The pairs as pair-major (P, Q) tensors at batch one."""
        return (self._to_dev(pair_major(pack_g1, [[p] for p, _ in pairs])),
                self._to_dev(pair_major(pack_g2, [[q] for _, q in pairs])))

    def pairing(self, p, q):
        return self.pairing_batch([(p, q)])

    def pairing_batch(self, pairs):
        return unpack_fq12(PC.pairing_batch(*self._pairs(pairs)).cpu().numpy())[0]

    def pairing_batch_is_one(self, pairs):
        return bool(PC.pairing_batch_is_one(*self._pairs(pairs))[0].item())

"""PyTorch compute backend for the protocol verifiers.

The counterpart of snark_bn254_verifier_tpu/models/jax_backend.py
(``JaxBackend``, jax_backend.py:140-197 there), with the OracleBackend
interface of models/backend.py, so the protocol code (``verify_groth16``,
``PreparedVerifyingKey``, ``verify_plonk``) runs on it unchanged. Each primitive packs its host points into limb
tensors on the backend's device, runs its kernels and makes one copy back
to the host:

  msm, g1_mul            kernel K2 at batch one (a point per row)
  pairing, pairing_batch kernel K5 over the pairs, then kernel K4
  pairing_batch_is_one   the same, compared with one on the device; one
                         bool comes back

On a CUDA device every primitive goes through its kernels; a CPU device
runs their plain twins. MSMs of any size run on K2 (the JAX package
switches to Pippenger at 64 points, ops/msm.py:165; the port has no
Pippenger kernel yet).
"""

from __future__ import annotations

import torch

from ..oracle import bn254 as bn
from ..ops import pairing_cuda as PC
from ..ops import tower as T
from ..parallel.batch import resolve_device
from .packing import pack_fr_canonical, pack_g1, pack_g2, pair_major, unpack_fq12, unpack_g1


class TorchBackend:
    """Device-compute backend on one torch device ("cpu" or "cuda")."""

    name = "torch"

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def _to_dev(self, arrays) -> tuple:
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    # -- MSM ----------------------------------------------------------------

    def msm(self, points, scalars):
        n = len(points)
        if n != len(scalars):
            raise ValueError("one scalar per point")
        if n == 0:
            return None
        pts = self._to_dev(pair_major(pack_g1, [[p] for p in points]))
        # canonical Fr limbs, point-major: (n, 16, 1)
        sc = torch.as_tensor(pack_fr_canonical([s % bn.R for s in scalars]).T[:, :, None],
                             device=self.device).contiguous()
        return unpack_g1(*PC.msm_affine(pts, sc))[0]

    def g1_mul(self, point, scalar):
        return self.msm([point], [scalar])

    # -- pairings -----------------------------------------------------------

    def _gt(self, pairs) -> torch.Tensor:
        """prod e(P_i, Q_i) as a (16, 12, 1) device tensor."""
        ps = self._to_dev(pair_major(pack_g1, [[p] for p, _ in pairs]))
        qs = self._to_dev(pair_major(pack_g2, [[q] for _, q in pairs]))
        return PC.final_exp(PC.miller_product(ps, qs))

    def pairing(self, p, q):
        return self.pairing_batch([(p, q)])

    def pairing_batch(self, pairs):
        return unpack_fq12(self._gt(pairs).cpu().numpy())[0]

    def pairing_batch_is_one(self, pairs):
        gt = self._gt(pairs)
        return bool(T.fq12_eq(gt, T.fq12_one(gt.shape[2:], gt))[0].item())

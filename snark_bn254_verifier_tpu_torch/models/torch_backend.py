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
  msm_fixed              ops/pairing_cuda.py::msm_fixed at batch one, over
                         the window table that ``fixed_base_table`` built
                         once (a VK's points, at most FIXED_MAX_POINTS of
                         them): only the scalars go up
  pairing, pairing_batch ops/pairing_cuda.py::pairing_batch: kernel K5
                         over the pairs, then kernel K4
  pairing_batch_is_one   the same, compared with one on the device; one
                         bool comes back

While a ``torch.profiler`` session records, each primitive call records
a span (utils/profiling.py), ``bn254.backend.msm`` (both MSMs) or
``bn254.backend.pairing``, with two children: ``bn254.backend.pack`` (the
host packing and the copies to the device) and ``bn254.backend.read``
(the copy back, which waits for the card); and the counters
``bn254.backend.uploads`` (host-to-device copies) and
``bn254.backend.reads`` (device-to-host copies).

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
from ..utils.profiling import count, span
from .packing import (g1_from_rows, g1_rows, pack_fr_columns, pack_g1, pack_g2, pack_msm,
                      pair_major, unpack_fq12)


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
        count("bn254.backend.uploads", len(arrays))
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    @staticmethod
    def _read(t: torch.Tensor):
        """``t`` on the host as a numpy array: one copy, after the card."""
        with span("bn254.backend.read"):
            count("bn254.backend.reads")
            return t.cpu().numpy()

    # -- MSM ----------------------------------------------------------------

    def msm(self, points, scalars):
        n = len(points)
        if n != len(scalars):
            raise ValueError("one scalar per point")
        if n == 0:
            return None
        with span("bn254.backend.msm"):
            with span("bn254.backend.pack"):
                pts, sc = pack_msm(points, scalars)
                *pts, sc = self._to_dev((*pts, sc))
            out = M.msm_best(tuple(pts), sc)
            return g1_from_rows(self._read(g1_rows(*out)))[0]

    def fixed_base_table(self, points):
        """The window table of the fixed ``points`` on the backend's device,
        for ``msm_fixed`` (ops/pairing_cuda.py::fixed_base_table); None
        where there are none or more than ops/msm.py::use_fixed_table
        allows (``msm`` serves those)."""
        if not M.use_fixed_table(len(points)):
            return None
        return PC.fixed_base_table(self._to_dev(pack_g1(points)))

    def msm_fixed(self, table, scalars):
        """sum_j scalars[j] * points[j] of the points whose ``table`` this
        backend built, as ``msm`` gives it."""
        with span("bn254.backend.msm"):
            with span("bn254.backend.pack"):
                (sc,) = self._to_dev((pack_fr_columns([scalars], len(scalars), 1),))
            out = PC.msm_fixed(table, sc)
            return g1_from_rows(self._read(g1_rows(*out)))[0]

    def g1_mul(self, point, scalar):
        return self.msm([point], [scalar])

    # -- pairings -----------------------------------------------------------

    def _pairs(self, pairs) -> tuple:
        """The pairs as pair-major (P, Q) tensors at batch one."""
        with span("bn254.backend.pack"):
            return (self._to_dev(pair_major(pack_g1, [[p] for p, _ in pairs])),
                    self._to_dev(pair_major(pack_g2, [[q] for _, q in pairs])))

    def pairing(self, p, q):
        return self.pairing_batch([(p, q)])

    def pairing_batch(self, pairs):
        with span("bn254.backend.pairing"):
            return unpack_fq12(self._read(PC.pairing_batch(*self._pairs(pairs))))[0]

    def pairing_batch_is_one(self, pairs):
        with span("bn254.backend.pairing"):
            return bool(self._read(PC.pairing_batch_is_one(*self._pairs(pairs))[:1])[0])

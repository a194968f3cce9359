"""Batched Groth16 verification on PyTorch: the port's main path.

The counterpart of the Groth16 part of
snark_bn254_verifier_tpu/parallel/batch.py (``Groth16BatchVerifier``,
batch.py:125-366 there). Per batch:

  1. host: the native C++ parse (the Python parser where proof lengths
     differ), scalar and point packing, the copies to the device, the
     VK's (gamma, -delta) line tables and e(alpha, beta), both computed
     once per VK on the oracle;
  2. device: the G2 on-curve mask of the proofs' B points, kernel K1 in
     its fused form (g2_on_curve);
  3. the prepared input 1*k0 + sum in_i * k_{i+1}, kernel K2;
  4. the mixed Miller product of e(A, B), e(L, gamma), e(C, -delta),
     kernel K3, then the final exponentiation, kernel K4;
  5. the Gt compare against e(alpha, beta), ANDed with the validity mask.

A bad proof masks its lane False instead of raising. As in the JAX
package, B is checked to be on the curve but not to be in the subgroup.
On a CUDA device every stage goes through its kernel; a CPU device runs
the plain twins.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..oracle import bn254 as bn
from ..utils import errors
from ..utils import native
from ..utils import serialization as ser
from ..utils.profiling import RunStats
from ..models.packing import pack_fq12, pack_fr_canonical, pack_g1, pack_g2
from ..ops import lines as LN
from ..ops import pairing_cuda as PC
from ..ops import tower as T

R = bn.R


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class Groth16BatchVerifier:
    """VK-specialised batched Groth16 verifier on one torch device."""

    def __init__(self, vk_bytes: bytes, device="cuda"):
        self.device = resolve_device(device)
        self.vk = ser.load_groth16_verifying_key_from_bytes(vk_bytes)
        self.n_inputs = len(self.vk.k) - 1
        self._tables = None
        self._alpha_beta = None
        self.last_stats: Optional[RunStats] = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_dev(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr), device=self.device)

    def line_tables(self):
        """(lines, tails) tensors of gamma and -delta, built once per VK."""
        if self._tables is None:
            tabs = (LN.g2_line_table(self.vk.gamma_g2),
                    LN.g2_line_table(bn.g2_neg(self.vk.delta_g2)))
            self._tables = LN.tables_from_numpy(tabs, self.device)
        return self._tables

    def alpha_beta(self) -> torch.Tensor:
        """e(alpha, beta) as a (16, 12, 1) tensor, on the oracle once per VK
        (the device values are bit-identical, so it compares directly)."""
        if self._alpha_beta is None:
            ab = bn.pairing(self.vk.alpha_g1, self.vk.beta_g2)
            self._alpha_beta = self._to_dev(pack_fq12([ab]))
        return self._alpha_beta

    def verify_batch(self, proofs: Sequence[bytes],
                     public_inputs: Sequence[Sequence[int]]) -> np.ndarray:
        """One bool per proof: True where the proof verifies."""
        b = len(proofs)
        if len(public_inputs) != b:
            raise ValueError("one public-input list per proof")
        ms = {}
        t_start = t = time.perf_counter()

        def lap(stage):
            nonlocal t
            self._sync()
            now = time.perf_counter()
            ms[stage] = (now - t) * 1e3
            t = now

        parsed = self._parse_native(proofs)
        parser = "native" if parsed is not None else "python"
        ar, bs, krs, valid = parsed if parsed is not None else self._parse_python(proofs)
        lap("parse_ms")

        scalars = []
        for i, ins in enumerate(public_inputs):
            if len(ins) != self.n_inputs:
                valid[i] = False
                scalars.append([0] * self.n_inputs)
            else:
                scalars.append([s % R for s in ins])
        # prepared input = 1*k0 + sum in_i * k_{i+1} (k0 folded in with scalar 1)
        sc = np.stack(
            [pack_fr_canonical([1] * b)]
            + [pack_fr_canonical([row[j] for row in scalars])
               for j in range(self.n_inputs)]
        )
        kx, ky, kinf = pack_g1(self.vk.k)
        k_points = tuple(np.ascontiguousarray(np.broadcast_to(a[..., None], a.shape + (b,)))
                         for a in (kx.T, ky.T, kinf))
        lap("pack_ms")

        k_points = tuple(self._to_dev(x) for x in k_points)
        sc = self._to_dev(sc)
        ar, bs, krs = (tuple(self._to_dev(x) for x in pt) for pt in (ar, bs, krs))
        lines, tails = self.line_tables()
        alpha_beta = self.alpha_beta()
        valid = self._to_dev(valid)
        lap("upload_ms")

        if parser == "native":  # the Python parser checked the curve itself
            valid = PC.g2_on_curve(bs, valid)
        lap("g2_mask_ms")
        prepared = PC.msm_affine(k_points, sc)
        lap("msm_ms")
        f = PC.miller_mixed(ar, bs, (prepared, krs), lines, tails)
        lap("miller_ms")
        gt = PC.final_exp(f)
        lap("final_exp_ms")
        ok = (T.fq12_eq(gt, alpha_beta) & valid).cpu().numpy()
        lap("compare_ms")

        self.last_stats = RunStats(
            protocol="groth16",
            batch_size=b,
            n_chips=1,
            elapsed_s=time.perf_counter() - t_start,
            n_valid=int(ok.sum()),
            pairings_per_proof=3,  # e(A,B) e(L,gamma) e(C,-delta) vs e(alpha,beta)
            extra={"device": str(self.device), "parser": parser, "stage_ms": ms},
        )
        return ok

    def _parse_native(self, proofs: Sequence[bytes]):
        """Native batch parse (C++); None when the library is unavailable or
        proof lengths differ. G2 on-curve is left to the device mask."""
        if not proofs or not native.native_available():
            return None
        stride = len(proofs[0])
        if stride < 256 or any(len(p) != stride for p in proofs):
            return None
        b = len(proofs)
        outs = native.parse_groth16_batch(b"".join(proofs), stride, b)
        zeros = np.zeros(b, dtype=bool)

        def limbs(key):
            return outs[key].astype(np.int32)

        ar = (limbs("ar_x"), limbs("ar_y"), zeros)
        krs = (limbs("krs_x"), limbs("krs_y"), zeros)
        bs = (
            np.stack([limbs("bs_x0"), limbs("bs_x1")], 1),
            np.stack([limbs("bs_y0"), limbs("bs_y1")], 1),
            zeros,
        )
        return ar, bs, krs, np.array(outs["valid"], dtype=bool)

    def _parse_python(self, proofs: Sequence[bytes]):
        b = len(proofs)
        valid = np.ones(b, dtype=bool)
        ars, bss, krss = [], [], []
        for i, pb in enumerate(proofs):
            try:
                proof = ser.load_groth16_proof_from_bytes(pb)
                ars.append(proof.ar)
                bss.append(proof.bs)
                krss.append(proof.krs)
            except (errors.VerifierError, IndexError, ValueError):
                valid[i] = False
                ars.append(bn.G1_GEN)
                bss.append(bn.G2_GEN)
                krss.append(bn.G1_GEN)
        return pack_g1(ars), pack_g2(bss), pack_g1(krss), valid

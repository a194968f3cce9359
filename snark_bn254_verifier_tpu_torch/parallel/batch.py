"""Batched Groth16 and PlonK verification on PyTorch.

The counterpart of snark_bn254_verifier_tpu/parallel/batch.py: its
``Groth16BatchVerifier`` (batch.py:125-366 there) and its
``PlonkBatchVerifier`` (batch.py:430-733, with ``_plonk_final_kernel``
:392, ``_batch_inv_mod_r`` :409 and ``_unpack_affine`` :736).

Groth16, per batch:

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

As in the JAX package, B is checked to be on the curve but not to be in
the subgroup.

PlonK, per batch (two device phases with a host step between: the KZG
fold challenge binds the device-computed linearisation digest,
plonk/verify.rs:284 -> kzg.rs:46 of the reference):

  1. host: the per-lane parse and count checks, the Fiat-Shamir
     challenges, one batch inversion mod r for every lane's
     denominators, the linearisation scalars and the early check of the
     linearisation constant;
  2. phase A, device: the linearisation MSM (nb_BSB22 + 10 points),
     kernel K2, and one copy of the digests back to the host;
  3. host: the KZG fold challenge gamma (models/kzg.py::derive_gamma)
     and the randomisers;
  4. phase B, device (``_plonk_final``): the combo MSM and the quotient
     MSM, kernel K2; e(combo, [1]_2) * e(-quotient, [x]_2) as a
     fixed-only Miller product over the VK's line tables, kernel K3, then
     kernel K4 and the compare against one, ANDed with the validity mask.

PlonK proofs hold only G1 points, so there is no G2 mask. A bad proof
masks its lane False instead of raising. On a CUDA device every stage
goes through its kernel; a CPU device runs the plain twins. Every MSM
goes through ops/msm.py::msm_best, as the JAX package's _msm_affine
(batch.py:177-197 there): Pippenger (K6) where ops/msm.py::use_pippenger
says (16 points or more, at most 4 lanes a point), which only a Groth16 VK
with 15 or more public inputs reaches, and then only in small batches;
else K2.

``verify_batch_async`` (batch.py:280-325 and :478-627 there) returns the
device bool tensor without waiting for the card, so the caller can parse
and pack the next batch while this one runs; ``verify_batch`` is that
call plus one copy to the host. On CUDA each batch in flight runs on a
stream of its own (``_Ring``: IN_FLIGHT streams taken in turn), each
phase's host arrays go to the card in one copy, without blocking, from
that stream's pinned staging buffer, and one event marks the batch's
end. PlonK keeps its phase-A round trip: the digests come to the host
for the KZG fold challenge, then phase B is left in flight.
"""

from __future__ import annotations

import contextlib
import secrets
import struct
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..oracle import bn254 as bn
from ..utils import errors
from ..utils import native
from ..utils import serialization as ser
from ..utils.hash_to_field import WrappedHashToField
from ..utils.profiling import RunStats
from ..utils.transcript import ALPHA, BETA, GAMMA, ZETA, Transcript
from ..models import kzg as kzg_mod
from ..models import plonk as plonk_mod
from ..models.torch_backend import resolve_device
from ..models.packing import (pack_fq12, pack_fr_canonical, pack_g1, pack_g2, packer,
                              stack_g1, unpack_g1_rows)
from ..ops import field as F
from ..ops import lines as LN
from ..ops import msm as M
from ..ops import pairing_cuda as PC
from ..ops import tower as T

R = bn.R
IN_FLIGHT = 2  # CUDA streams a verifier cycles through, one a batch in flight
_ALIGN = 16  # bytes between staged arrays: every dtype's view stays aligned


def _event() -> torch.cuda.Event:
    """A timing event recorded on the current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Stages:
    """Stage times of one batch, taken without waiting for the card: a
    host stage is a ``perf_counter`` lap (``host``); a device stage
    (``device``), on CUDA, the time between two events on the batch's
    stream, from the last device stage or ``begin``; on the CPU every
    stage is a host lap. Host time spent queueing device work is no
    stage. ``ms()`` reads the events, so only after the batch's end."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.start = self.t = time.perf_counter()
        self.total = {}  # stage -> host ms so far
        self.spans = []  # (stage, start event, end event)
        self.last = None

    def host(self, stage: str) -> None:
        now = time.perf_counter()
        self.total[stage] = self.total.get(stage, 0.0) + (now - self.t) * 1e3
        self.t = now

    def resume(self) -> None:
        """Start the next host lap now (after a wait for the card)."""
        self.t = time.perf_counter()

    def begin(self) -> None:
        if self.cuda:
            self.last = _event()
        self.resume()

    def device(self, stage: str) -> None:
        if not self.cuda:
            return self.host(stage)
        ev = _event()
        self.spans.append((stage, self.last, ev))
        self.total.setdefault(stage, 0.0)
        self.last = ev
        self.resume()

    def ms(self) -> dict:
        out = dict(self.total)
        for stage, a, b in self.spans:
            out[stage] += a.elapsed_time(b)
        return out

    def host_ms(self) -> dict:
        """The stages that need no wait for the card: the host laps (on
        the CPU every stage)."""
        on_card = {stage for stage, _, _ in self.spans}
        return {k: v for k, v in self.total.items() if k not in on_card}

    def elapsed_s(self) -> float:
        return time.perf_counter() - self.start


class _Slot:
    """One stream of a ``_Ring``, its pinned staging buffer (kept from
    batch to batch, grown when short), and its latest batch's end event."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.staging = torch.empty(0, dtype=torch.uint8)
        self.end: Optional[torch.cuda.Event] = None


class _Ring:
    """IN_FLIGHT CUDA streams, taken in turn, one a batch. A slot is handed
    out again only after its previous batch's end event, so that batch no
    longer reads the slot's staging buffer; with more than IN_FLIGHT
    batches queued, ``take`` waits for the oldest."""

    def __init__(self, device: torch.device):
        self.device = device
        self.slots: List[_Slot] = []
        self.count = 0

    def take(self) -> _Slot:
        if len(self.slots) < IN_FLIGHT:
            self.slots.append(_Slot(self.device))
        slot = self.slots[self.count % IN_FLIGHT]
        self.count += 1
        if slot.end is not None:
            slot.end.synchronize()
        slot.end = None
        return slot


class _Run:
    """A dispatched batch: its (B,) bool tensor on the device, its stage
    clock and, on CUDA, its ring slot."""

    def __init__(self, ok: torch.Tensor, stages: _Stages, slot: Optional[_Slot] = None,
                 extra: Optional[dict] = None):
        self.ok, self.stages, self.slot = ok, stages, slot
        self.extra = extra or {}

    def handed_over(self) -> torch.Tensor:
        """The bools for the caller, without a host sync: the caller's
        current stream waits for the batch's end, so the tensor is ready
        for any work queued there (``.cpu()`` included)."""
        if self.slot is not None:
            with torch.cuda.stream(self.slot.stream):
                self.slot.end = torch.cuda.Event()
                self.slot.end.record()
            current = torch.cuda.current_stream(self.ok.device)
            current.wait_event(self.slot.end)
            self.ok.record_stream(current)
        return self.ok

    def on_host(self) -> np.ndarray:
        """The bools on the host: one copy (into a pinned buffer, on the
        batch's stream, booked to ``compare_ms``), then a wait for the
        batch's end."""
        if self.slot is None:
            return self.ok.cpu().numpy()
        with torch.cuda.stream(self.slot.stream):
            host = torch.empty(self.ok.shape, dtype=torch.bool, pin_memory=True)
            host.copy_(self.ok, non_blocking=True)
            self.stages.device("compare_ms")
            self.slot.end = torch.cuda.Event()
            self.slot.end.record()
        self.slot.end.synchronize()
        return host.numpy()


class _Flights:
    """What both batch verifiers share: the host->device copies and the
    streams of the batches in flight."""

    device: torch.device

    def _init_flights(self) -> None:
        self._ring = _Ring(self.device) if self.device.type == "cuda" else None
        self._vk_ready = False

    def _to_dev(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr), device=self.device)

    def _vk_tensors(self) -> None:
        """Build the VK's cached device tensors once, then wait for them
        on CUDA: every batch's stream reads them, so they must be written
        before the first batch starts."""
        raise NotImplementedError

    def _flight(self):
        """(slot, context) for the device part of a batch: on CUDA the next
        slot of the ring and its stream as the current one; on the CPU no
        slot and no stream."""
        if not self._vk_ready:
            self._vk_tensors()
            if self._ring is not None:
                torch.cuda.synchronize(self.device)
            self._vk_ready = True
        if self._ring is None:
            return None, contextlib.nullcontext()
        slot = self._ring.take()
        return slot, torch.cuda.stream(slot.stream)

    def _upload(self, slot: Optional[_Slot], *arrays) -> list:
        """Host arrays on the device: on CUDA in one copy, without
        blocking, on the current stream, through the slot's pinned staging
        buffer. The buffer is rewritten, so its previous copy must have
        ended: the slot's last batch has, and PlonK's phase-A copy ended
        before its digests were read."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        if slot is None:
            return [torch.as_tensor(a, device=self.device) for a in arrays]
        need = _staged_bytes(arrays)
        if slot.staging.numel() < need:
            slot.staging = torch.empty(need, dtype=torch.uint8, pin_memory=True)
        return _staged(arrays, slot.staging, self.device)


def _staged_bytes(arrays) -> int:
    return sum(-(-a.nbytes // _ALIGN) * _ALIGN for a in arrays)


def _staged(arrays, staging: torch.Tensor, device: torch.device) -> list:
    """The contiguous ``arrays`` packed into the uint8 host tensor
    ``staging`` at aligned offsets, copied to ``device`` in one copy (not
    blocking where ``staging`` is pinned) and viewed back as the arrays."""
    host = staging.numpy()
    offsets, off = [], 0
    for a in arrays:
        host[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        offsets.append(off)
        off += -(-a.nbytes // _ALIGN) * _ALIGN
    dev = staging[:off].to(device, non_blocking=True)
    return [dev[o:o + a.nbytes].view(torch.from_numpy(a[:0]).dtype).view(a.shape)
            for a, o in zip(arrays, offsets)]

class Groth16BatchVerifier(_Flights):
    """VK-specialised batched Groth16 verifier on one torch device."""

    def __init__(self, vk_bytes: bytes, device="cuda"):
        self.device = resolve_device(device)
        self.vk = ser.load_groth16_verifying_key_from_bytes(vk_bytes)
        self.n_inputs = len(self.vk.k) - 1
        self._tables = None
        self._alpha_beta = None
        self._k_points = _fixed_points(self.vk.k, self.device)
        self.last_stats: Optional[RunStats] = None
        self._init_flights()

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

    def _vk_tensors(self) -> None:
        self.line_tables()
        self.alpha_beta()

    def verify_batch(self, proofs: Sequence[bytes],
                     public_inputs: Sequence[Sequence[int]]) -> np.ndarray:
        """One bool per proof: True where the proof verifies.
        ``verify_batch_async`` plus one copy to the host; fills
        ``last_stats`` (``extra["stage_ms"]``: host stages by host laps,
        device stages by CUDA events on CUDA; ``extra["host_s"]``: the
        host stages' seconds)."""
        run = self._dispatch(proofs, public_inputs)
        ok = run.on_host()
        self.last_stats = self._stats(run, len(proofs), int(ok.sum()), run.stages.ms())
        return ok

    def verify_batch_async(self, proofs: Sequence[bytes],
                           public_inputs: Sequence[Sequence[int]]) -> torch.Tensor:
        """The (B,) bool tensor of ``verify_batch`` on the verifier's
        device, returned without waiting for the card: on CUDA the batch
        runs on a stream of its own, and the caller's current stream waits
        for it, so ``.cpu()`` (or any work queued there) sees the result.
        Fills ``last_stats`` with what is known without that wait: the
        host stages, ``elapsed_s`` the call's host time, ``n_valid`` None."""
        run = self._dispatch(proofs, public_inputs)
        self.last_stats = self._stats(run, len(proofs), None, run.stages.host_ms())
        return run.handed_over()

    def _stats(self, run: _Run, b: int, n_valid: Optional[int], ms: dict) -> RunStats:
        return RunStats(
            protocol="groth16",
            batch_size=b,
            n_chips=1,
            elapsed_s=run.stages.elapsed_s(),
            n_valid=n_valid,
            pairings_per_proof=3,  # e(A,B) e(L,gamma) e(C,-delta) vs e(alpha,beta)
            extra={"device": str(self.device), **run.extra, "packer": packer(),
                   "stage_ms": ms,
                   "host_s": sum(ms.get(k, 0.0) for k in ("parse_ms", "pack_ms")) / 1e3},
        )

    def _dispatch(self, proofs: Sequence[bytes],
                  public_inputs: Sequence[Sequence[int]]) -> _Run:
        b = len(proofs)
        if len(public_inputs) != b:
            raise ValueError("one public-input list per proof")
        stages = _Stages(self.device)
        parsed = self._parse_native(proofs)
        parser = "native" if parsed is not None else "python"
        ar, bs, krs, valid = parsed if parsed is not None else self._parse_python(proofs)
        stages.host("parse_ms")

        # prepared input = 1*k0 + sum in_i * k_{i+1} (k0 folded in with scalar 1)
        cols = []
        for i, ins in enumerate(public_inputs):
            if len(ins) != self.n_inputs:
                valid[i] = False
                cols.append(None)
            else:
                cols.append([1] + [s % R for s in ins])
        sc = _pack_columns(cols, self.n_inputs + 1, b)
        stages.host("pack_ms")

        slot, stream = self._flight()
        with stream:
            stages.begin()
            k_points = tuple(v.expand(v.shape[:-1] + (b,)) for v in self._k_points)
            sc, valid, *flat = self._upload(slot, sc, valid, *ar, *bs, *krs)
            ar, bs, krs = tuple(flat[:3]), tuple(flat[3:6]), tuple(flat[6:])
            lines, tails = self.line_tables()
            stages.device("upload_ms")

            if parser == "native":  # the Python parser checked the curve itself
                valid = PC.g2_on_curve(bs, valid)
            stages.device("g2_mask_ms")
            prepared = M.msm_best(k_points, sc)
            stages.device("msm_ms")
            f = PC.miller_mixed(ar, bs, (prepared, krs), lines, tails)
            stages.device("miller_ms")
            gt = PC.final_exp(f)
            stages.device("final_exp_ms")
            ok = T.fq12_eq(gt, self.alpha_beta()) & valid
            stages.device("compare_ms")
        return _Run(ok, stages, slot, {"parser": parser})

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


def _fixed_points(points, device) -> tuple:
    """VK points -> (x (k,16,1), y (k,16,1), inf (k,1)) tensors on the
    device: packed once per VK, expanded to the batch at each call."""
    x, y, inf = pack_g1(points)
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                 for a in (x.T[..., None], y.T[..., None], inf[:, None]))


def _batch_inv_mod_r(values: Sequence[int]) -> List[Optional[int]]:
    """Montgomery-trick inversion mod r of every value with one modular
    exponentiation for the whole batch; a zero value gives None (its lane
    is masked False) without spoiling the others."""
    n = len(values)
    safe = [v % R or 1 for v in values]
    prefix = [1] * (n + 1)
    for i, v in enumerate(safe):
        prefix[i + 1] = prefix[i] * v % R
    inv_all = pow(prefix[n], R - 2, R)
    out: List[Optional[int]] = [None] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % R if values[i] % R else None
        inv_all = inv_all * safe[i] % R
    return out


def _plonk_final(take, combo_rest, quot, digest, sc, lines, tails, one, valid, stage):
    """Phase B on the device: the combo MSM (the phase-A ``digest``, then
    the rows ``combo_rest`` of ``take``) and the quotient MSM (rows
    ``quot``), kernel K2, with their scalars stacked in ``sc``; the
    quotient negated; e(combo, [1]_2) * e(-quot, [x]_2) as a fixed-only
    Miller product over the line tables, kernel K3; kernel K4; the
    compare with ``one``, ANDed with ``valid``. Returns the (B,) bool
    tensor on the device; ``stage`` names each stage as it ends."""
    n_combo = len(combo_rest) + 1
    combo = tuple(torch.cat([d.unsqueeze(0), t]) for d, t in zip(digest, take(combo_rest)))
    combo = M.msm_best(combo, sc[:n_combo])
    qx, qy, qinf = M.msm_best(take(quot), sc[n_combo:])
    stage("msm_b_ms")
    neg_quot = (qx, F.fq_neg(qy), qinf)  # zero stays zero: infinity stays (0, 0)
    f = PC.miller_mixed(None, None, (combo, neg_quot), lines, tails)
    stage("miller_ms")
    gt = PC.final_exp(f)
    stage("final_exp_ms")
    ok = T.fq12_eq(gt, one) & valid
    stage("compare_ms")
    return ok


class PlonkBatchVerifier(_Flights):
    """VK-specialised batched PlonK verifier on one torch device (gnark
    semantics, BSB22 commitments included; a bad lane is masked False)."""

    def __init__(self, vk_bytes: bytes, device="cuda"):
        self.device = resolve_device(device)
        self.vk = ser.load_plonk_verifying_key_from_bytes(vk_bytes)
        vk = self.vk
        # the domain generator's powers, the same for every lane: w^i for
        # the public inputs' Lagrange terms (plonk/verify.rs:116-137) and
        # w^(nb_public + cci) for BSB22 (plonk/verify.rs:147-152)
        self._w_pows = [1]
        for _ in range(max(vk.nb_public_variables, 1) - 1):
            self._w_pows.append(self._w_pows[-1] * vk.generator % R)
        self._cci_wpow = [
            pow(vk.generator, vk.nb_public_variables + cci, R)
            for cci in vk.commitment_constraint_indexes
        ]
        # Rows of the phase-A point upload: each lane's proof points, then
        # the VK's points, packed once and broadcast to the batch.
        nb = len(vk.qcp)
        lane_rows = [f"cmt{j}" for j in range(nb)] + [
            "l", "r", "o", "z", "h0", "h1", "h2", "hb", "hs"]
        vk_rows = ["ql", "qr", "qm", "qo", "qk", "s2", "s0", "s1"] + [
            f"qcp{j}" for j in range(nb)] + ["g1"]
        self._n_lane_rows = len(lane_rows)
        self._vk_points = _fixed_points([vk.ql, vk.qr, vk.qm, vk.qo, vk.qk, vk.s[2], vk.s[0],
                                         vk.s[1], *vk.qcp, vk.kzg.g1], self.device)
        self._one = self._to_dev(pack_fq12([bn.FQ12_ONE]))
        row = {name: i for i, name in enumerate(lane_rows + vk_rows)}

        def rows(*names):
            return torch.tensor([row[n] for n in names], device=self.device)

        cmts = [f"cmt{j}" for j in range(nb)]
        # plonk/verify.rs:264-279 (lin), kzg.rs:87-126 and :150-178 (combo)
        self._lin = rows(*cmts, "ql", "qr", "qm", "qo", "qk", "s2", "z", "h0", "h1", "h2")
        self._combo_rest = rows("l", "r", "o", "s0", "s1", *[f"qcp{j}" for j in range(nb)],
                                "z", "g1", "hb", "hs")
        self._quot = rows("hb", "hs")
        self._tables = None  # KZG ([1]_2, [x]_2) Miller line tables, lazy
        self.last_stats: Optional[RunStats] = None
        self._init_flights()

    def _vk_tensors(self) -> None:
        self._kzg_tables()

    def _kzg_tables(self):
        """(lines, tails) of the KZG SRS's [1]_2 and [x]_2, both VK-fixed
        (kzg.rs:180-186), built once per VK."""
        if self._tables is None:
            tabs = (LN.g2_line_table(self.vk.kzg.g2[0]), LN.g2_line_table(self.vk.kzg.g2[1]))
            self._tables = LN.tables_from_numpy(tabs, self.device)
        return self._tables

    def verify_batch(self, proofs: Sequence[bytes], public_inputs: Sequence[Sequence[int]],
                     rng=None) -> np.ndarray:
        """One bool per proof: True where the proof verifies. ``rng`` draws
        the KZG randomisers (a callable returning a nonzero Fr int), by
        default from ``secrets``. ``verify_batch_async`` plus one copy to
        the host; fills ``last_stats`` (stage times as Groth16's)."""
        run = self._dispatch(proofs, public_inputs, rng)
        ok = run.on_host()
        self.last_stats = self._stats(len(proofs), int(ok.sum()), run.stages, run.stages.ms())
        return ok

    def verify_batch_async(self, proofs: Sequence[bytes],
                           public_inputs: Sequence[Sequence[int]], rng=None) -> torch.Tensor:
        """The (B,) bool tensor of ``verify_batch`` on the verifier's
        device. It waits for the card once, for the phase-A digests that
        the KZG fold challenge binds; phase B is left in flight on the
        batch's stream, which the caller's current stream waits for.
        Fills ``last_stats`` as Groth16's does (every host stage is known
        by then)."""
        run = self._dispatch(proofs, public_inputs, rng)
        self.last_stats = self._stats(len(proofs), None, run.stages, run.stages.host_ms())
        return run.handed_over()

    def _dispatch(self, proofs: Sequence[bytes], public_inputs: Sequence[Sequence[int]],
                  rng) -> _Run:
        vk = self.vk
        b = len(proofs)
        if len(public_inputs) != b:
            raise ValueError("one public-input list per proof")
        stages = _Stages(self.device)
        valid = np.ones(b, dtype=bool)
        parsed: List[Optional[ser.PlonkProof]] = []
        for i, pb in enumerate(proofs):
            try:
                proof = ser.load_plonk_proof_from_bytes(pb)
                if len(proof.bsb22_commitments) != len(vk.qcp):
                    raise errors.Bsb22CommitmentMismatchError()
                if len(public_inputs[i]) != vk.nb_public_variables:
                    raise errors.InvalidWitnessError()
                # one claimed value per digest of the KZG fold, as
                # kzg.fold_proof demands on the single-proof path
                if len(proof.batched_proof.claimed_values) != 6 + len(vk.qcp):
                    raise errors.InvalidNumberOfDigestsError(6 + len(vk.qcp))
                parsed.append(proof)
            except (errors.VerifierError, IndexError, ValueError, struct.error):
                valid[i] = False
                parsed.append(None)
        stages.host("parse_ms")

        # pass 1: the challenges and every denominator of the lane; one
        # inversion for the whole batch; pass 2: the rest, products only
        chs: List[Optional[dict]] = []
        denoms: List[int] = []
        for i, proof in enumerate(parsed):
            ch = None
            if proof is not None:
                try:
                    ch = self._lane_challenges(proof, public_inputs[i])
                    denoms.extend(ch["denoms"])
                except errors.VerifierError:
                    valid[i] = False
            chs.append(ch)
        invs = _batch_inv_mod_r(denoms)
        lanes: List[Optional[dict]] = []
        pos = 0
        for i, ch in enumerate(chs):
            lane = None
            if ch is not None:
                k = len(ch["denoms"])
                lane_invs = invs[pos:pos + k]
                pos += k
                try:
                    if any(v is None for v in lane_invs):
                        raise errors.InverseNotFoundError()  # zeta on the domain
                    lane = self._lane_finish(parsed[i], public_inputs[i], ch, lane_invs)
                except errors.VerifierError:
                    valid[i] = False
            lanes.append(lane)
        stages.host("host_a_ms")

        if not any(lane is not None for lane in lanes):  # no lane reaches the card
            return _Run(torch.zeros(b, dtype=torch.bool, device=self.device), stages)

        # phase A: every lane's proof points (each VK point once), the
        # linearisation scalars; dead lanes carry G1_GEN and scalar 0
        m = self._n_lane_rows
        lane_pts = [[bn.G1_GEN] * m if proof is None else
                    [*proof.bsb22_commitments, *proof.lro, proof.z, *proof.h,
                     proof.batched_proof.h, proof.z_shifted_opening.h] for proof in parsed]
        x, y, inf = pack_g1([lp[j] for j in range(m) for lp in lane_pts])
        pts = (x.reshape(16, m, b).swapaxes(0, 1), y.reshape(16, m, b).swapaxes(0, 1),
               inf.reshape(m, b))
        lin_sc = _pack_columns([lane and lane["lin_scalars"] for lane in lanes],
                               len(self._lin), b)
        stages.host("pack_a_ms")

        slot, stream = self._flight()
        with stream:
            stages.begin()
            lin_sc, *pts = self._upload(slot, lin_sc, *pts)
            pts = tuple(torch.cat([a, v.expand(v.shape[:-1] + (b,))])
                        for a, v in zip(pts, self._vk_points))
            lines, tails = self._kzg_tables()
            stages.device("upload_a_ms")

            def take(idx):
                return tuple(t.index_select(0, idx) for t in pts)

            digest = M.msm_best(take(self._lin), lin_sc)
            stages.device("msm_a_ms")
            digests_host = _digests_on_host(digest, slot, stages)

            # host: the KZG fold challenge binds the digest; the randomisers
            rand_fr = rng if rng is not None else (lambda: secrets.randbelow(R - 1) + 1)
            cols = [None if lane is None else
                    self._lane_fold(parsed[i], lane["zeta"], digests_host[i], rand_fr)
                    for i, lane in enumerate(lanes)]
            stages.host("host_b_ms")
            sc = _pack_columns(cols, len(self._combo_rest) + 1 + len(self._quot), b)
            stages.host("pack_b_ms")
            stages.begin()
            sc, tvalid = self._upload(slot, sc, valid)
            stages.device("upload_b_ms")

            ok = _plonk_final(take, self._combo_rest, self._quot, digest, sc, lines, tails,
                              self._one, tvalid, stages.device)
        return _Run(ok, stages, slot)

    def _stats(self, b: int, n_valid: Optional[int], stages: _Stages, ms: dict) -> RunStats:
        host = ("parse_ms", "host_a_ms", "pack_a_ms", "host_b_ms", "pack_b_ms")
        return RunStats(
            protocol="plonk",
            batch_size=b,
            n_chips=1,
            elapsed_s=stages.elapsed_s(),
            n_valid=n_valid,
            pairings_per_proof=2,  # the KZG two-pair batch check (kzg.rs:180-186)
            extra={"device": str(self.device), "packer": packer(), "stage_ms": ms,
                   "host_s": sum(ms.get(k, 0.0) for k in host) / 1e3},
        )

    # -- host scalar work (reference plonk/verify.rs:62-279 semantics) ------

    def _lane_challenges(self, proof: ser.PlonkProof, inputs: Sequence[int]) -> dict:
        """Pass 1: the Fiat-Shamir challenges and every denominator this
        lane needs inverted (inverted across lanes by the caller)."""
        vk = self.vk
        fs = Transcript([GAMMA, BETA, ALPHA, ZETA])
        plonk_mod.bind_public_data(fs, GAMMA, vk, inputs)
        gamma = plonk_mod.derive_randomness(fs, GAMMA, list(proof.lro))
        beta = plonk_mod.derive_randomness(fs, BETA)
        alpha = plonk_mod.derive_randomness(
            fs, ALPHA, list(proof.bsb22_commitments) + [proof.z])
        zeta = plonk_mod.derive_randomness(fs, ZETA, list(proof.h))
        zeta_n = pow(zeta, vk.size, R)  # vk.size is a power of two
        denoms = [(zeta - 1) % R]
        denoms.extend((zeta - w) % R for w in self._w_pows[:len(inputs)])
        denoms.extend((zeta - w) % R for w in self._cci_wpow)
        return {"gamma": gamma, "beta": beta, "alpha": alpha, "zeta": zeta,
                "zeta_n": zeta_n, "denoms": denoms}

    def _lane_finish(self, proof: ser.PlonkProof, inputs: Sequence[int], ch: dict,
                     invs: Sequence[int]) -> dict:
        """Pass 2: the remaining Fr algebra, products only; raises
        OpeningPolyMismatchError where the linearisation constant differs."""
        vk = self.vk
        gamma, beta, alpha, zeta = ch["gamma"], ch["beta"], ch["alpha"], ch["zeta"]
        zeta_n = ch["zeta_n"]
        zh_zeta = (zeta_n - 1) % R
        lagrange_one = invs[0] * zh_zeta % R * vk.size_inv % R

        pi = 0
        for j, w in enumerate(inputs):
            li = zh_zeta * invs[1 + j] % R * vk.size_inv % R * self._w_pows[j] % R
            pi = (pi + li * (w % R)) % R
        htf = WrappedHashToField(plonk_mod.BSB22_DST)
        base = 1 + len(inputs)
        for i, w_pow_i in enumerate(self._cci_wpow):
            htf.write(ser.g1_to_bytes(proof.bsb22_commitments[i]))
            hashed = int.from_bytes(htf.sum(), "big") % R
            htf.reset()
            lagrange = zh_zeta * w_pow_i % R * invs[base + i] % R * vk.size_inv % R
            pi = (pi + lagrange * hashed) % R

        cv = proof.batched_proof.claimed_values
        l, r_, o, s1, s2 = cv[1], cv[2], cv[3], cv[4], cv[5]
        zu = proof.z_shifted_opening.claimed_value
        alpha_sq_l1 = lagrange_one * alpha % R * alpha % R
        const_lin = (beta * s1 + gamma + l) % R
        const_lin = const_lin * ((beta * s2 + gamma + r_) % R) % R
        const_lin = const_lin * ((o + gamma) % R) % R * alpha % R * zu % R
        const_lin = (const_lin - alpha_sq_l1 + pi) % R
        const_lin = (-const_lin) % R
        if const_lin != cv[0] % R:
            raise errors.OpeningPolyMismatchError()

        _s1 = (beta * s1 + l + gamma) % R * ((beta * s2 + r_ + gamma) % R) % R
        _s1 = _s1 * beta % R * alpha % R * zu % R
        u = vk.coset_shift
        _s2 = (beta * zeta + gamma + l) % R
        _s2 = _s2 * ((beta * u % R * zeta + gamma + r_) % R) % R
        _s2 = _s2 * ((beta * u % R * u % R * zeta + gamma + o) % R) % R
        _s2 = (-(_s2 * alpha)) % R
        coeff_z = (alpha_sq_l1 + _s2) % R
        rl = l * r_ % R
        zeta_n2 = zeta_n * zeta % R * zeta % R
        zn2_zh = (-(zeta_n2 * zh_zeta)) % R
        zn2sq_zh = (-(zeta_n2 * zeta_n2 % R * zh_zeta)) % R
        zh_neg = (-zh_zeta) % R

        lin_points = list(proof.bsb22_commitments) + [
            vk.ql, vk.qr, vk.qm, vk.qo, vk.qk, vk.s[2],
            proof.z, proof.h[0], proof.h[1], proof.h[2],
        ]
        qc = [v % R for v in cv[6:]]
        lin_scalars = qc + [l, r_, rl, o, 1, _s1, coeff_z, zh_neg, zn2_zh, zn2sq_zh]
        return {"zeta": zeta, "lin_points": lin_points, "lin_scalars": lin_scalars}

    def _lane_fold(self, proof: ser.PlonkProof, zeta: int, lin_digest, rand_fr) -> list:
        """After phase A: the KZG fold challenge over this lane's digests
        (models/kzg.py::derive_gamma, bound to the device digest) and one
        randomiser; returns the combo MSM's scalars, then the quotient
        MSM's (kzg.rs:87-186 folded into two MSMs)."""
        vk = self.vk
        digests = [lin_digest, *proof.lro, vk.s[0], vk.s[1], *vk.qcp]
        cv = proof.batched_proof.claimed_values
        zu = proof.z_shifted_opening.claimed_value
        gamma_fold = kzg_mod.derive_gamma(zeta, digests, cv, ser.fr_to_bytes_be(zu))
        gpow = [1]
        for _ in range(len(digests) - 1):
            gpow.append(gpow[-1] * gamma_fold % R)
        folded_eval = sum(v * c for v, c in zip(cv, gpow)) % R
        r_rand = rand_fr()
        shifted = zeta * vk.generator % R
        fe_total = (folded_eval + r_rand * zu) % R
        # combo = sum gpow_i digest_i + r z - fe_total [1]_1 + zeta H_b + r shifted H_s
        return gpow + [r_rand, (-fe_total) % R, zeta, r_rand * shifted % R, 1, r_rand]


def _digests_on_host(digest, slot: Optional[_Slot], stages: _Stages) -> List:
    """Phase A's affine digests as oracle points, booked to
    ``digest_copy_ms``: one copy to the host (on CUDA into a pinned buffer
    on the batch's stream, an event-timed stage, then a wait for this
    batch alone) and the unpacking (a host lap)."""
    both = stack_g1(*digest)
    if slot is not None:
        host = torch.empty(both.shape, dtype=both.dtype, pin_memory=True)
        host.copy_(both, non_blocking=True)
        stages.device("digest_copy_ms")
        stages.last.synchronize()
        stages.resume()
        both = host
    rows = unpack_g1_rows(both.numpy())
    stages.host("digest_copy_ms")
    return rows


def _pack_columns(cols, n: int, b: int) -> np.ndarray:
    """Per-lane lists of n canonical Fr scalars (None: a dead lane, all
    zero) -> (n, 16, b) limbs, in one packer call."""
    flat = [0] * (n * b)
    for lane, col in enumerate(cols):
        if col is not None:
            flat[lane::b] = col
    return pack_fr_canonical(flat).reshape(16, n, b).swapaxes(0, 1)

"""Batched Groth16 and PlonK verification on PyTorch.

The counterpart of snark_bn254_verifier_tpu/parallel/batch.py: its
``Groth16BatchVerifier`` (batch.py:125-366 there) and its
``PlonkBatchVerifier`` (batch.py:430-733, with ``_plonk_final_kernel``
:392 and ``_unpack_affine`` :736).

Groth16, per batch:

  1. host: the native C++ parse (the Python parser where proof lengths
     differ), scalar and point packing, the copies to the device, the
     VK's (gamma, -delta) line tables and e(alpha, beta), both computed
     once per VK on the oracle;
  2. device: the G2 on-curve mask of the proofs' B points, kernel K1 in
     its fused form (g2_on_curve);
  3. the prepared input 1*k0 + sum in_i * k_{i+1}, kernel msm_fixed, over
     the window table of k0..kn that the constructor builds once
     (ops/pairing_cuda.py::fixed_base_table), where the VK has at most
     ops/msm.py::FIXED_MAX_POINTS points; past that through msm_best;
  4. the mixed Miller product of e(A, B), e(L, gamma), e(C, -delta):
     kernel g2_lines prepares the lines of (A, B) into the ring slot's
     buffer, kernel K3 multiplies them and the VK's tables into f; then
     the final exponentiation, kernel K4;
  5. the Gt compare against e(alpha, beta), ANDed with the validity mask.

As in the JAX package, B is checked to be on the curve but not to be in
the subgroup.

PlonK, per batch, with no wait for the card anywhere (the KZG fold
challenge binds the device-computed linearisation digest,
plonk/verify.rs:284 -> kzg.rs:46 of the reference, so it is computed on
the card too):

  1. host (numpy, ops/plonk_lanes.py): the proofs joined into one (B, L)
     byte array and the byte checks (length, the counts of claimed values
     and commitments, the public-input count), the inputs and one
     randomiser a surviving lane packed as canonical Fr, one upload;
  2. kernel K7a (plonk_lanes_a): each lane's points and values decoded and
     checked, the Fiat-Shamir challenges, BSB22's hash to field, the
     linearisation scalars and the early check of the linearisation
     constant;
  3. phase A: the linearisation MSM (nb_BSB22 + 10 points), kernel K2;
  4. kernel K7b (plonk_lanes_b): the KZG fold challenge gamma over phase
     A's digest (models/kzg.py::derive_gamma), its powers, the folded
     evaluation and the randomiser terms;
  5. phase B (``_plonk_final``): the combo MSM and the quotient MSM,
     kernel K2; e(combo, [1]_2) * e(-quotient, [x]_2) as a fixed-only
     Miller product over the VK's line tables, kernel K3, then kernel K4
     and the compare against one, ANDed with K7a's validity mask.

PlonK proofs hold only G1 points, so there is no G2 mask. A bad proof
masks its lane False instead of raising. On a CUDA device every stage
goes through its kernel; a CPU device runs the plain twins. Every PlonK
MSM goes through ops/msm.py::msm_best, as the JAX package's _msm_affine
(batch.py:177-197 there): Pippenger (K6) where ops/msm.py::use_pippenger
says (16 points or more, at most 4 lanes a point), else K2. The Groth16
MSM's points are the VK's, the same in every lane, so it takes the
fixed-base kernel at any batch size, on a VK of at most FIXED_MAX_POINTS
points; a larger VK's goes through msm_best too.

``verify_batch_async`` (batch.py:280-325 and :478-627 there) returns the
device bool tensor without waiting for the card, so the caller can parse
and pack the next batch while this one runs; ``verify_batch`` is that
call plus one copy to the host. On CUDA each batch in flight runs on a
stream of its own (``_Ring``: IN_FLIGHT streams taken in turn), its
host arrays go to the card in one copy, without blocking, from
that stream's pinned staging buffer, and one event marks the batch's
end. The tensor handed back is a ``HandedOver``: its first use on a
stream makes that stream wait for its own batch's end, so reading batch
n-2 waits for batch n-2 alone, as blocking on the JAX package's
``jax.Array`` does, and dispatch queues no wait on the caller's stream.

While a ``torch.profiler`` session records, both verifiers record their
spans and counters (utils/profiling.py): ``bn254.batch.dispatch`` around
each call, inside it ``bn254.batch.parse`` and ``bn254.batch.pack`` (the
host stages), ``bn254.ring.wait`` (the wait for a free stream),
``bn254.batch.upload`` (staging and queueing the copy) and
``bn254.batch.launch`` (every kernel and glue op queued, the bools
handed over); counters ``bn254.batch.lanes``, ``bn254.batch.host_rejects``
(lanes the host's parse and byte checks mask) and
``bn254.batch.python_parse`` (batches parsed in Python).
"""

from __future__ import annotations

import contextlib
import secrets
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from torch.utils._pytree import tree_flatten, tree_map

from ..oracle import bn254 as bn
from ..utils import errors
from ..utils import native
from ..utils import serialization as ser
from ..utils.profiling import RunStats, count, span
from ..models.torch_backend import resolve_device
from ..models.packing import pack_fq12, pack_fr_columns, pack_g1, pack_g2, packer
from ..ops import field as F
from ..ops import lines as LN
from ..ops import msm as M
from ..ops import pairing_cuda as PC
from ..ops import plonk_lanes as PL
from ..ops import tower as T

R = bn.R
IN_FLIGHT = 2  # CUDA streams a verifier cycles through, one a batch in flight
_ALIGN = 16  # bytes between staged arrays: every dtype's view stays aligned


class _Stages:
    """Stage times of one batch, as ``perf_counter`` laps: a host stage
    (``host``) always; a device stage (``device``) on the CPU alone, where
    the twins run synchronously. On CUDA a device stage is not timed, and
    the host time spent queueing device work is no stage."""

    def __init__(self, device: torch.device):
        self.cpu = device.type != "cuda"
        self.start = self.t = time.perf_counter()
        self.ms = {}  # stage -> host ms so far

    def host(self, stage: str) -> None:
        now = time.perf_counter()
        self.ms[stage] = self.ms.get(stage, 0.0) + (now - self.t) * 1e3
        self.t = now

    def resume(self) -> None:
        """Start the next host lap now (after a wait for the card)."""
        self.t = time.perf_counter()

    def device(self, stage: str) -> None:
        if self.cpu:
            return self.host(stage)
        self.resume()

    def elapsed_s(self) -> float:
        return time.perf_counter() - self.start


class _Slot:
    """One stream of a ``_Ring``, its pinned staging buffer and its buffer
    of K3's variable line rows (each kept from batch to batch, grown when
    short), and its latest batch's end event."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.staging = torch.empty(0, dtype=torch.uint8)
        self.rows = torch.empty(0, dtype=torch.int32)
        self.end: Optional[torch.cuda.Event] = None

    def line_rows(self, b: int) -> torch.Tensor:
        """The slot's buffer for a batch of b lanes' variable line rows
        (ops/pairing_cuda.py::g2_lines), allocated on the slot's stream
        (the current one) when short. The slot's last batch, the only
        other user, has ended when the slot is handed out."""
        need = PC.line_rows_words(b)
        if self.rows.numel() < need:
            self.rows = torch.empty(need, dtype=torch.int32, device=self.stream.device)
        return self.rows

    def mark_end(self) -> torch.cuda.Event:
        """Record the end of the work queued on the slot's stream so far,
        as the slot's end event, and return it."""
        with torch.cuda.stream(self.stream):
            self.end = torch.cuda.Event()
            self.end.record()
        return self.end


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
            with span("bn254.ring.wait"):
                slot.end.synchronize()
        slot.end = None
        return slot


class _Run:
    """A dispatched batch: its (B,) bool tensor on the device, its stage
    clock and, on CUDA, its ring slot. With ``hand_over``, ``out`` holds
    the bools for the caller (``handed_over()``), taken as the run is
    made."""

    def __init__(self, ok: torch.Tensor, stages: _Stages, slot: Optional[_Slot] = None,
                 extra: Optional[dict] = None, hand_over: bool = False):
        self.ok, self.stages, self.slot = ok, stages, slot
        self.extra = extra or {}
        self.out = self.handed_over() if hand_over else None

    def handed_over(self, current=None, wait=None) -> torch.Tensor:
        """The bools for the caller, without a host sync and without a
        wait queued on the caller's stream: on CUDA the batch's end event
        is recorded on its stream and the bools come back as a
        ``HandedOver``, which waits for that event on first use. On the
        CPU the plain tensor. ``current`` and ``wait`` are HandedOver's
        stream lookup and waiter (the CUDA ones by default)."""
        if self.slot is None:
            return self.ok
        return HandedOver.wrap(self.ok, self.slot.mark_end(), current or _current_stream,
                               wait or _stream_wait)

    def on_host(self) -> np.ndarray:
        """The bools on the host: one copy (into a pinned buffer, on the
        batch's stream), then a wait for the batch's end."""
        if self.slot is None:
            return self.ok.cpu().numpy()
        with torch.cuda.stream(self.slot.stream):
            host = torch.empty(self.ok.shape, dtype=torch.bool, pin_memory=True)
            host.copy_(self.ok, non_blocking=True)
        self.slot.mark_end().synchronize()
        return host.numpy()


def _current_stream(device: torch.device):
    return torch.cuda.current_stream(device)


def _stream_wait(stream, end, ok: torch.Tensor) -> None:
    """``stream`` waits for the event ``end`` on the card (no host sync),
    and the allocator keeps ``ok``'s memory until ``stream``'s work so far
    has ended."""
    stream.wait_event(end)
    ok.record_stream(stream)


_T = torch.Tensor
# reads of a tensor's metadata, which need none of its values: no wait
_METADATA = {_T.shape.__get__, _T.dtype.__get__, _T.device.__get__, _T.is_cuda.__get__,
             _T.ndim.__get__, _T.size, _T.dim, _T.numel, _T.__len__}


class HandedOver(torch.Tensor):
    """The (B,) bools that ``verify_batch_async`` returns on CUDA: a
    ``torch.Tensor`` whose values are ready on a stream only after that
    stream waits for the batch's end event.

    Every torch op given the tensor (``.cpu()``, ``.tolist()``,
    ``.numpy()``, indexing, ``==``, an op queued on any stream, the
    tensor among an op's arguments) passes through ``__torch_function__``,
    which, on the tensor's first use from a stream, makes that stream wait
    for the batch's end (a wait on the card, not on the host) and
    ``record_stream``s the tensor there, so its memory is not reused
    before that stream's work ends; a later use from the same stream
    waits for nothing more, one from another stream waits once there. The
    op then runs on the plain tensor and returns plain tensors. Reading
    metadata (shape, dtype, device, size, len) waits for nothing.

    So dispatching a batch queues no wait on the caller's stream, and
    reading batch n-2 while n-1 and n run waits for batch n-2 alone: the
    two-in-flight loop overlaps (a wait queued at dispatch made a read of
    n-2 queue behind the waits for n-1 and n). A caller may still use the
    tensor on its current stream with no extra call, as any tensor.

    ``current(device)`` gives the using stream and ``wait(stream, end,
    tensor)`` queues the wait (``_current_stream`` and ``_stream_wait``
    on CUDA); both are arguments so that the ordering can be checked on
    the CPU with stand-ins."""

    _end = None
    _waited: list
    _dev: torch.device

    @classmethod
    def wrap(cls, ok: torch.Tensor, end, current, wait) -> "HandedOver":
        with torch._C.DisableTorchFunctionSubclass():
            out = ok.as_subclass(cls)
            out._dev = ok.device
        out._end, out._waited, out._current, out._wait = end, [], current, wait
        return out

    def _first_use(self) -> None:
        stream = self._current(self._dev)
        if stream not in self._waited:
            with torch._C.DisableTorchFunctionSubclass():
                self._wait(stream, self._end, self)
            self._waited.append(stream)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _METADATA:
            for t in tree_flatten((args, kwargs))[0]:
                if isinstance(t, HandedOver):
                    t._first_use()
        with torch._C.DisableTorchFunctionSubclass():
            args, kwargs = tree_map(_plain, (args, kwargs))
            return func(*args, **kwargs)


def _plain(x):
    """A HandedOver as a plain tensor on the same memory; anything else
    as it is."""
    return x.as_subclass(torch.Tensor) if isinstance(x, HandedOver) else x


class _Flights:
    """What both batch verifiers share: the public calls, their stats, the
    host->device copies and the streams of the batches in flight. A
    verifier names its ``PROTOCOL`` and ``PAIRINGS_PER_PROOF`` and gives
    its constructor, ``_vk_tensors`` and ``_dispatch``."""

    PROTOCOL: str
    PAIRINGS_PER_PROOF: int
    device: torch.device

    def _init_flights(self) -> None:
        self._ring = _Ring(self.device) if self.device.type == "cuda" else None
        self._vk_ready = False
        self.last_stats: Optional[RunStats] = None

    def verify_batch(self, proofs: Sequence[bytes], public_inputs: Sequence[Sequence[int]],
                     rng=None) -> np.ndarray:
        """One bool per proof: True where the proof verifies.
        ``verify_batch_async`` plus one copy to the host; fills
        ``last_stats`` (``extra["stage_ms"]``: the stages by host laps,
        the host stages alone on CUDA, every stage on the CPU;
        ``extra["host_s"]``: the host stages' seconds).

        PlonK's ``rng`` draws the KZG randomisers (a callable returning a
        nonzero Fr int), by default from ``secrets``: one a lane that
        passes the host's byte checks, in lane order, before any device
        stage (the JAX package draws after its host pass, for the lanes
        still alive; the bools do not depend on the draws). A Groth16
        batch draws none."""
        with span("bn254.batch.dispatch"):
            run = self._dispatch(proofs, public_inputs, rng, hand_over=False)
            ok = run.on_host()
            self.last_stats = self._stats(run, len(proofs), int(ok.sum()))
            return ok

    def verify_batch_async(self, proofs: Sequence[bytes],
                           public_inputs: Sequence[Sequence[int]], rng=None) -> torch.Tensor:
        """The (B,) bool tensor of ``verify_batch`` on the verifier's
        device, returned without waiting for the card: on CUDA the batch
        (for PlonK both phases and the lane passes between them) runs on a
        stream of its own and the tensor is a ``HandedOver``, usable on
        any stream with no extra call (``.cpu()``, ``.tolist()``, any op),
        its first use on a stream waiting there for this batch alone; on
        the CPU a plain tensor. Fills ``last_stats`` with what is known
        without that wait: the host stages, ``elapsed_s`` the call's host
        time, ``n_valid`` None."""
        with span("bn254.batch.dispatch"):
            run = self._dispatch(proofs, public_inputs, rng, hand_over=True)
            self.last_stats = self._stats(run, len(proofs), None)
            return run.out

    def _stats(self, run: _Run, b: int, n_valid: Optional[int]) -> RunStats:
        ms = run.stages.ms
        return RunStats(
            protocol=self.PROTOCOL,
            batch_size=b,
            n_chips=1,
            elapsed_s=run.stages.elapsed_s(),
            n_valid=n_valid,
            pairings_per_proof=self.PAIRINGS_PER_PROOF,
            extra={"device": str(self.device), **run.extra, "packer": packer(),
                   "stage_ms": ms,
                   "host_s": sum(ms.get(k, 0.0) for k in ("parse_ms", "pack_ms")) / 1e3},
        )

    def _dispatch(self, proofs, public_inputs, rng, hand_over: bool) -> _Run:
        """Queue the batch's stages; ``hand_over`` asks for the bools in
        ``_Run.out``."""
        raise NotImplementedError

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
        ended: the slot's last batch has."""
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


def _count_lanes(b: int, valid: np.ndarray, parser: str = "native") -> None:
    """The batch's counters: its lanes, those the host masked, and one
    batch parsed in Python where ``parser`` says so."""
    count("bn254.batch.lanes", b)
    count("bn254.batch.host_rejects", b - int(np.count_nonzero(valid)))
    if parser == "python":
        count("bn254.batch.python_parse")


class Groth16BatchVerifier(_Flights):
    """VK-specialised batched Groth16 verifier on one torch device."""

    PROTOCOL = "groth16"
    PAIRINGS_PER_PROOF = 3  # e(A,B) e(L,gamma) e(C,-delta) vs e(alpha,beta)

    def __init__(self, vk_bytes: bytes, device="cuda"):
        self.device = resolve_device(device)
        self.vk = ser.load_groth16_verifying_key_from_bytes(vk_bytes)
        self.n_inputs = len(self.vk.k) - 1
        self._tables = None
        self._alpha_beta = None
        # The VK's points: their window table for msm_fixed while their
        # count allows one (ops/msm.py::use_fixed_table), else the points
        # for msm_best.
        self._k_table = self._k_points = None
        if M.use_fixed_table(len(self.vk.k)):
            self._k_table = PC.fixed_base_table(
                tuple(torch.as_tensor(a, device=self.device) for a in pack_g1(self.vk.k)))
        else:
            self._k_points = _fixed_points(self.vk.k, self.device)
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

    def _dispatch(self, proofs: Sequence[bytes], public_inputs: Sequence[Sequence[int]],
                  rng, hand_over: bool) -> _Run:
        b = len(proofs)
        if len(public_inputs) != b:
            raise ValueError("one public-input list per proof")
        with span("bn254.batch.parse"):
            stages = _Stages(self.device)
            parsed = self._parse_native(proofs)
            parser = "native" if parsed is not None else "python"
            ar, bs, krs, valid = parsed if parsed is not None else self._parse_python(proofs)
            stages.host("parse_ms")

        with span("bn254.batch.pack"):
            # prepared input = 1*k0 + sum in_i * k_{i+1} (k0 folded in with scalar 1)
            cols = []
            for i, ins in enumerate(public_inputs):
                if len(ins) != self.n_inputs:
                    valid[i] = False
                    cols.append(None)
                else:
                    cols.append([1, *ins])
            sc = pack_fr_columns(cols, self.n_inputs + 1, b)
            stages.host("pack_ms")
        _count_lanes(b, valid, parser)

        slot, stream = self._flight()
        with stream:
            with span("bn254.batch.upload"):
                stages.resume()
                sc, valid, *flat = self._upload(slot, sc, valid, *ar, *bs, *krs)
            with span("bn254.batch.launch"):
                ar, bs, krs = tuple(flat[:3]), tuple(flat[3:6]), tuple(flat[6:])
                lines, tails = self.line_tables()
                stages.device("upload_ms")

                if parser == "native":  # the Python parser checked the curve itself
                    valid = PC.g2_on_curve(bs, valid)
                stages.device("g2_mask_ms")
                if self._k_table is not None:
                    prepared = PC.msm_fixed(self._k_table, sc)
                else:
                    prepared = M.msm_best(
                        tuple(v.expand(v.shape[:-1] + (b,)) for v in self._k_points), sc)
                stages.device("msm_ms")
                rows = slot.line_rows(b) if slot is not None else None
                f = PC.miller_mixed(ar, bs, (prepared, krs), lines, tails, rows=rows)
                stages.device("miller_ms")
                gt = PC.final_exp(f)
                stages.device("final_exp_ms")
                ok = T.fq12_eq(gt, self.alpha_beta()) & valid
                stages.device("compare_ms")
                return _Run(ok, stages, slot, {"parser": parser}, hand_over)

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

    PROTOCOL = "plonk"
    PAIRINGS_PER_PROOF = 2  # the KZG two-pair batch check (kzg.rs:180-186)

    def __init__(self, vk_bytes: bytes, device="cuda"):
        self.device = resolve_device(device)
        self.vk = ser.load_plonk_verifying_key_from_bytes(vk_bytes)
        vk = self.vk
        self._lanes_vk = PL.LanesVk(vk)
        # Rows of phase A's points: each lane's proof points (K7a writes
        # them), then the VK's points, packed once and broadcast to the batch.
        nb = len(vk.qcp)
        lane_rows = [f"cmt{j}" for j in range(nb)] + [
            "l", "r", "o", "z", "h0", "h1", "h2", "hb", "hs"]
        vk_rows = ["ql", "qr", "qm", "qo", "qk", "s2", "s0", "s1"] + [
            f"qcp{j}" for j in range(nb)] + ["g1"]
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
        self._init_flights()

    def _vk_tensors(self) -> None:
        self._kzg_tables()
        self._lanes_vk.words(self.device)

    def _kzg_tables(self):
        """(lines, tails) of the KZG SRS's [1]_2 and [x]_2, both VK-fixed
        (kzg.rs:180-186), built once per VK."""
        if self._tables is None:
            tabs = (LN.g2_line_table(self.vk.kzg.g2[0]), LN.g2_line_table(self.vk.kzg.g2[1]))
            self._tables = LN.tables_from_numpy(tabs, self.device)
        return self._tables

    def _dispatch(self, proofs: Sequence[bytes], public_inputs: Sequence[Sequence[int]],
                  rng, hand_over: bool) -> _Run:
        lvk = self._lanes_vk
        b = len(proofs)
        if len(public_inputs) != b:
            raise ValueError("one public-input list per proof")
        with span("bn254.batch.parse"):
            stages = _Stages(self.device)
            raw, valid = PL.pack_proofs(proofs, lvk)
            counted = np.fromiter((len(ins) == lvk.nb_pub for ins in public_inputs),
                                  dtype=bool, count=b)
            valid &= counted  # InvalidWitnessError otherwise
            stages.host("parse_ms")
        _count_lanes(b, valid)
        if not valid.any():  # no lane reaches the card
            return _Run(torch.zeros(b, dtype=torch.bool, device=self.device), stages,
                        hand_over=hand_over)

        with span("bn254.batch.pack"):
            pub = pack_fr_columns([ins if ok else None
                                   for ins, ok in zip(public_inputs, counted)], lvk.nb_pub, b)
            rand_fr = rng if rng is not None else (lambda: secrets.randbelow(R - 1) + 1)
            rand = pack_fr_columns([[rand_fr()] if ok else None for ok in valid], 1, b)[0]
            stages.host("pack_ms")

        slot, stream = self._flight()
        with stream:
            with span("bn254.batch.upload"):
                stages.resume()
                raw, pub, rand, valid = self._upload(slot, raw, pub, rand, valid)
            with span("bn254.batch.launch"):
                lines, tails = self._kzg_tables()
                stages.device("upload_ms")
                # K7a: the lanes' checks, transcripts and linearisation scalars
                valid, zeta, lane_pts, lin_sc = PC.plonk_lanes_a(raw, pub, valid, lvk)
                pts = tuple(torch.cat([a, v.expand(v.shape[:-1] + (b,))])
                            for a, v in zip(lane_pts, self._vk_points))
                stages.device("lanes_a_ms")

                def take(idx):
                    return tuple(t.index_select(0, idx) for t in pts)

                digest = M.msm_best(take(self._lin), lin_sc)
                stages.device("msm_a_ms")
                # K7b: the KZG fold challenge binds the digest, on the card
                sc = PC.plonk_lanes_b(raw, valid, zeta, rand, digest, lvk)
                stages.device("lanes_b_ms")
                ok = _plonk_final(take, self._combo_rest, self._quot, digest, sc, lines,
                                  tails, self._one, valid, stages.device)
                return _Run(ok, stages, slot, hand_over=hand_over)

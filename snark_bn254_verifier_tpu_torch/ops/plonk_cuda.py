"""Wrappers of kernel K7 (CUDA, csrc/plonk.cuh), the PlonK batch's per-lane
scalar pass, with its plain twins in ops/plonk_lanes.py.

  plonk_lanes_a   K7a, before phase A: the proof bytes decoded and
                  checked, the gamma/beta/alpha/zeta transcript, BSB22's
                  hash to field, the linearisation's Fr algebra
  plonk_lanes_b   K7b, between the phases: the KZG fold challenge over
                  phase A's digest and the scalars of phase B's MSMs

Neither has a Pallas original: the JAX package runs this pass in Python on
the host (snark_bn254_verifier_tpu/parallel/batch.py:575-600 and
:642-733). As every wrapper of the port's kernels, each sends CPU tensors
to its twin and CUDA tensors to its kernel, checks device, dtype, shape
and contiguity, allocates its outputs with ``torch.empty``, launches on
the current stream, raises on a CUDA error and counts its launches in
``<wrapper>.launches``. ops/pairing_cuda.py re-exports both and lists them
in KERNEL_ENTRY_POINTS. Each kernel copies its block's proof rows into
shared memory a 4-byte word at a time, sized from the proof length
(808 + 96 nb bytes), so the entry refuses (and the wrapper raises on) a
``raw`` whose rows are not a proof's length or whose start is not
4-byte aligned. The rows and the hand-over slots of a block grow with
the VK's BSB22 commitments nb: above 48 KB (K7b from nb = 2, K7a from
nb = 3) the entry raises the kernel's shared-memory limit, and past
K7_MAX_NB commitments they no longer fit the 227 KB a block may have,
so the wrappers refuse such a VK on the card (its twin takes any nb).
"""

from __future__ import annotations

import torch

from . import plonk_lanes as PL
from .field_cuda import expect, launch, on_cpu
from .limbs import NUM_LIMBS

# The most BSB22 commitments the kernels' shared memory holds
# (csrc/plonk.cuh::k7_max_nb, which the host build's test holds this to)
K7_MAX_NB = 37


def check_nb(vk: PL.LanesVk) -> None:
    """Raise where the VK has more BSB22 commitments than K7 takes."""
    if vk.nb > K7_MAX_NB:
        raise ValueError(f"K7 takes at most {K7_MAX_NB} BSB22 commitments (a block's proof "
                         f"rows and slots in shared memory); the VK has {vk.nb}")


def _raw_checked(raw: torch.Tensor, vk: PL.LanesVk) -> int:
    check_nb(vk)
    b = raw.shape[0]
    expect("raw", raw, (b, vk.proof_len), torch.uint8)
    if not raw.is_contiguous():
        raise ValueError("raw: not contiguous")
    return b


def plonk_lanes_a(raw, pub, valid, vk: PL.LanesVk):
    """K7a over B lanes: raw (B, L) uint8 proof bytes (L = vk.proof_len),
    pub (nb_public, 16, B) canonical Fr limbs, valid (B,) bool. Returns
    (valid (B,) bool, zeta (16, B), (px, py (m, 16, B), pinf (m, B)),
    lin (nb + 10, 16, B)), as ops/plonk_lanes.py::plonk_lanes_a_plain."""
    if on_cpu(raw, pub, valid):
        return PL.plonk_lanes_a_plain(raw, pub, valid, vk)
    b = _raw_checked(raw, vk)
    expect("pub", pub, (vk.nb_pub, NUM_LIMBS, b))
    expect("valid", valid, (b,), torch.bool)
    pub, valid = pub.contiguous(), valid.contiguous()
    dev, m = raw.device, vk.nb + 9
    ok = torch.empty((b,), dtype=torch.bool, device=dev)
    zeta = torch.empty((NUM_LIMBS, b), dtype=torch.int32, device=dev)
    px = torch.empty((m, NUM_LIMBS, b), dtype=torch.int32, device=dev)
    py = torch.empty_like(px)
    pinf = torch.empty((m, b), dtype=torch.bool, device=dev)
    lin = torch.empty((vk.nb + 10, NUM_LIMBS, b), dtype=torch.int32, device=dev)
    if b:
        launch(dev, "bn_plonk_lanes_a", raw.data_ptr(), vk.proof_len, pub.data_ptr(),
               valid.data_ptr(), vk.words(dev).data_ptr(), ok.data_ptr(), zeta.data_ptr(),
               px.data_ptr(), py.data_ptr(), pinf.data_ptr(), lin.data_ptr(), b)
        plonk_lanes_a.launches += 1
    return ok, zeta, (px, py, pinf), lin


def plonk_lanes_b(raw, valid, zeta, rand, digest, vk: PL.LanesVk):
    """K7b over B lanes: raw as K7a's, valid (B,) bool and zeta (16, B)
    from K7a, rand (16, B) canonical randomisers, digest phase A's affine
    (x, y (16, B) int32 Montgomery, inf (B,) bool). Returns the
    (nb + 12, 16, B) canonical scalars of phase B's combo and quotient
    MSMs, as ops/plonk_lanes.py::plonk_lanes_b_plain."""
    dx, dy, dinf = digest
    if on_cpu(raw, valid, zeta, rand, dx, dy, dinf):
        return PL.plonk_lanes_b_plain(raw, valid, zeta, rand, digest, vk)
    b = _raw_checked(raw, vk)
    expect("valid", valid, (b,), torch.bool)
    for name, t in (("zeta", zeta), ("rand", rand), ("digest x", dx), ("digest y", dy)):
        expect(name, t, (NUM_LIMBS, b))
    expect("digest inf", dinf, (b,), torch.bool)
    valid, zeta, rand, dx, dy, dinf = (t.contiguous() for t in (valid, zeta, rand, dx, dy, dinf))
    sc = torch.empty((vk.nb + 12, NUM_LIMBS, b), dtype=torch.int32, device=raw.device)
    if b:
        launch(raw.device, "bn_plonk_lanes_b", raw.data_ptr(), vk.proof_len, valid.data_ptr(),
               zeta.data_ptr(), rand.data_ptr(), dx.data_ptr(), dy.data_ptr(), dinf.data_ptr(),
               vk.words(raw.device).data_ptr(), sc.data_ptr(), b)
        plonk_lanes_b.launches += 1
    return sc


plonk_lanes_a.launches = 0
plonk_lanes_b.launches = 0

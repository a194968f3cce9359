"""Wrappers of the fused K1 and kernels K2-K6 (CUDA), and the port's
kernel registry.

The counterparts of the entry points of
snark_bn254_verifier_tpu/ops/pairing_pallas.py, and of the G2 on-curve
mask around field_pallas.py's K1 (``_g2_on_curve_jit`` of the JAX
package's parallel/batch.py):

  g2_on_curve     K1 fused with the mask's Fq2 arithmetic, replaces
                  _mont_kernel (field_pallas.py:37) on the main path
  msm_affine      K2, replaces _msm_windowed_kernel + _jacobian_combine_kernel
  miller_mixed    K3, replaces _miller_mixed_kernel
  final_exp       K4, replaces _fe_easy_expx_kernel + _fe_combine_kernel
  miller_product  K5, replaces _miller_kernel + _fq12_product_kernel
  msm_pippenger   K6, the bucket MSM of ops/msm.py, which is XLA in the
                  JAX package (ops/msm.py::msm_pippenger), with no Pallas
                  original

and, over K5 and K4, the whole pairings ``pairing``, ``pairing_batch``
and ``pairing_batch_is_one`` of ops/pairing.py.

Each wrapper sends a CPU tensor to its plain twin and a CUDA tensor to
its kernel, checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on its tensors' device and that
device's current stream, raises on a CUDA error and counts its launches
in ``<wrapper>.launches``. No wrapper pads the batch: the kernels mask
the ragged edge. g2_on_curve runs one thread per lane; K2-K5 run on a team of threads per lane, at the shapes
csrc/msm.cuh (K2) and csrc/team.cuh (K3-K5) fix; K6 is six launches
(csrc/pippenger.cuh): a digit pass and a counting sort, the bucket sums
over fixed chunks of all rows' entries, a thread a chunk, the merge of
buckets split between chunks, a block per (lane, window) for the window
sums, and a team of four threads per lane for the combine, which
``msm_pippenger_combine`` also offers alone (for sharded_msm).
"""

from __future__ import annotations

import ctypes

import torch

from . import curve as C
from . import msm as M
from . import pairing as PR
from . import tower as T
from ._build import load_kernels
from .field_cuda import launch, mont_mul
from .lines import STEPS
from .limbs import NUM_LIMBS

# Every kernel the port launches; tests/test_torch_kernel_registry.py
# holds it equal to the wrappers with a launch counter and to the phases
# of chip_smoke.py, so no kernel ships without an on-card check.
KERNEL_ENTRY_POINTS = ("mont_mul", "g2_on_curve", "msm_affine", "miller_mixed",
                       "final_exp", "miller_product", "msm_pippenger")


NF_MAX = 2  # fixed pairs whose line tables K3 stages in shared memory


def launch_counts() -> dict:
    return {name: globals()[name].launches for name in KERNEL_ENTRY_POINTS}


def reset_launch_counts() -> None:
    for name in KERNEL_ENTRY_POINTS:
        globals()[name].launches = 0


def _on_cpu(*tensors) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _expect(name: str, t: torch.Tensor, shape, dtype=torch.int32):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _zero_masked(x: torch.Tensor, mask: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """Zero lanes where ``mask`` is set: the kernels read infinity from the
    all-zero encoding. ``mask`` has x's first ``lead`` axes (the pair axis)
    followed by its batch axes."""
    shape = tuple(mask.shape)
    m = mask.view(shape[:lead] + (1,) * (x.dim() - mask.dim()) + shape[lead:])
    return torch.where(m, torch.zeros_like(x), x).contiguous()


def g2_on_curve(bs, valid):
    """valid & (inf | y^2 == x^3 + b') per lane: the main path's G2
    on-curve mask of the proofs' B points. bs = (x (16,2,B), y (16,2,B)
    int32 Montgomery limbs, inf (B,) bool), valid (B,) bool; returns a
    (B,) bool tensor."""
    x, y, inf = bs
    if _on_cpu(x, y, inf, valid):
        return C.g2_on_curve(bs, valid)
    b = x.shape[-1]
    _expect("x", x, (NUM_LIMBS, 2, b))
    _expect("y", y, (NUM_LIMBS, 2, b))
    _expect("inf", inf, (b,), torch.bool)
    _expect("valid", valid, (b,), torch.bool)
    for name, t in (("x", x), ("y", y), ("inf", inf), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"g2_on_curve: {name} is not contiguous")
    out = torch.empty((b,), dtype=torch.bool, device=x.device)
    if b == 0:
        return out
    launch(out.device, "bn_g2_on_curve", x.data_ptr(), y.data_ptr(), inf.data_ptr(),
           valid.data_ptr(), out.data_ptr(), b)
    g2_on_curve.launches += 1
    return out


def msm_affine(points, scalars):
    """Per-lane MSM sum_j scalars[j] * points[j] in affine form.

    points: (x (n,16,B), y (n,16,B), inf (n,B) bool) Montgomery limbs;
    scalars: (n,16,B) canonical Fr limbs. Returns (x (16,B) int32,
    y (16,B) int32, inf (B,) bool); infinity is (0, 0, True)."""
    px, py, pinf = points
    if _on_cpu(px, py, pinf, scalars):
        return C.msm_affine(points, scalars)
    n, _, b = px.shape
    if n < 1:
        raise ValueError("msm_affine: needs at least one point")
    for name, t in (("px", px), ("py", py), ("scalars", scalars)):
        _expect(name, t, (n, NUM_LIMBS, b))
    _expect("pinf", pinf, (n, b), torch.bool)
    px, py, scalars = px.contiguous(), py.contiguous(), scalars.contiguous()
    pinf8 = pinf.to(torch.uint8).contiguous()
    ox = torch.empty((NUM_LIMBS, b), dtype=torch.int32, device=px.device)
    oy = torch.empty_like(ox)
    oinf = torch.empty((b,), dtype=torch.bool, device=px.device)
    if b == 0:
        return ox, oy, oinf
    launch(ox.device, "bn_msm_affine", px.data_ptr(), py.data_ptr(), pinf8.data_ptr(),
           scalars.data_ptr(), n, ox.data_ptr(), oy.data_ptr(), oinf.data_ptr(), b)
    msm_affine.launches += 1
    return ox, oy, oinf


def miller_mixed(var_p, var_q, fixed_ps, lines, tails):
    """Mixed Miller product: the optional variable pair (var_p, var_q as
    affine (x, y, inf) tuples, G2 coords (16,2,B)) times nf VK-fixed pairs
    (fixed_ps: affine G1 tuples) with line tables lines (nf,4,STEPS,16,2)
    and tails (nf,2,2,16,2) (ops/lines.py::tables_from_numpy). Returns the
    (16,12,B) int32 Miller value."""
    has_var = var_p is not None
    tensors = [t for p in fixed_ps for t in p] + [lines, tails]
    if has_var:
        tensors += list(var_p) + list(var_q)
    if _on_cpu(*tensors):
        return PR.miller_mixed(var_p, var_q, fixed_ps, lines, tails)
    nf = len(fixed_ps)
    if nf > NF_MAX:
        raise ValueError(f"miller_mixed: at most {NF_MAX} fixed pairs, got {nf}")
    b = fixed_ps[0][0].shape[-1] if nf else var_p[0].shape[-1]
    _expect("lines", lines, (nf, 4, STEPS, NUM_LIMBS, 2))
    _expect("tails", tails, (nf, 2, 2, NUM_LIMBS, 2))
    for j, (x, y, inf) in enumerate(fixed_ps):
        _expect(f"fixed[{j}].x", x, (NUM_LIMBS, b))
        _expect(f"fixed[{j}].y", y, (NUM_LIMBS, b))
        _expect(f"fixed[{j}].inf", inf, (b,), torch.bool)
    dev = tensors[0].device
    if nf:
        fpx = torch.stack([_zero_masked(x, inf) for x, _, inf in fixed_ps])
        fpy = torch.stack([_zero_masked(y, inf) for _, y, inf in fixed_ps])
    else:
        fpx = fpy = torch.empty((0, NUM_LIMBS, b), dtype=torch.int32, device=dev)
    var = [None] * 4
    if has_var:
        _expect("var_p.x", var_p[0], (NUM_LIMBS, b))
        _expect("var_p.y", var_p[1], (NUM_LIMBS, b))
        _expect("var_q.x", var_q[0], (NUM_LIMBS, 2, b))
        _expect("var_q.y", var_q[1], (NUM_LIMBS, 2, b))
        skip = var_p[2] | var_q[2]
        var = [_zero_masked(t, skip)
               for t in (var_p[0], var_p[1], var_q[0], var_q[1])]
    lines, tails = lines.contiguous(), tails.contiguous()
    out = torch.empty((NUM_LIMBS, 12, b), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    launch(dev, "bn_miller_mixed", *[t.data_ptr() if t is not None else None for t in var],
           fpx.data_ptr(), fpy.data_ptr(), nf, lines.data_ptr(), tails.data_ptr(),
           out.data_ptr(), b)
    miller_mixed.launches += 1
    return out


def final_exp(f):
    """f^((p^12-1)/r) of a (16,12,B) int32 Fq12 batch."""
    if _on_cpu(f):
        return PR.final_exp(f)
    _expect("f", f, (NUM_LIMBS, 12, f.shape[-1]))
    f = f.contiguous()
    out = torch.empty_like(f)
    if f.shape[-1] == 0:
        return out
    launch(f.device, "bn_final_exp", f.data_ptr(), out.data_ptr(), f.shape[-1])
    final_exp.launches += 1
    return out


def miller_product(pairs_p, pairs_q):
    """Product over the pair axis of one Miller loop per (P, Q) pair, in
    the layout of the JAX package's ``miller_product_mega``: pairs_p =
    (x (n,16,B), y (n,16,B), inf (n,B)) and pairs_q = (x (n,16,2,B),
    y (n,16,2,B), inf (n,B)), Montgomery limbs. Infinite pairs contribute
    one. Returns the (16,12,B) int32 Miller value."""
    px, py, pinf = pairs_p
    qx, qy, qinf = pairs_q
    n = px.shape[0]
    if n < 1:
        raise ValueError("miller_product: needs at least one pair")
    if _on_cpu(px, py, pinf, qx, qy, qinf):
        return PR.miller_product(pairs_p, pairs_q)
    b = px.shape[-1]
    _expect("px", px, (n, NUM_LIMBS, b))
    _expect("py", py, (n, NUM_LIMBS, b))
    _expect("qx", qx, (n, NUM_LIMBS, 2, b))
    _expect("qy", qy, (n, NUM_LIMBS, 2, b))
    _expect("pinf", pinf, (n, b), torch.bool)
    _expect("qinf", qinf, (n, b), torch.bool)
    skip = pinf | qinf
    px, py, qx, qy = (_zero_masked(t, skip, lead=1) for t in (px, py, qx, qy))
    out = torch.empty((NUM_LIMBS, 12, b), dtype=torch.int32, device=px.device)
    if b == 0:
        return out
    launch(out.device, "bn_miller_product", px.data_ptr(), py.data_ptr(), qx.data_ptr(),
           qy.data_ptr(), n, out.data_ptr(), b)
    miller_product.launches += 1
    return out


# Entries a thread of K6's bucket stage (csrc/pippenger.cuh): the fastest of
# chip_smoke.py's PIP_CHUNKS at 2^16 points on an H100 (PERF.md). Shorter
# chunks pay more merges, longer ones leave SMs idle.
PIPPENGER_CHUNK = 64


def _pippenger_args(points, scalars, c: int, chunk: int):
    """K6's checked inputs on the card: (px, py, pinf as bytes, scalars,
    n, b, scratch), the scratch as bn_msm_pippenger_scratch_bytes says."""
    px, py, pinf = points
    n, _, b = px.shape
    if n < 1:
        raise ValueError("msm_pippenger: needs at least one point")
    if chunk < 1:
        raise ValueError(f"msm_pippenger: chunk={chunk} must be positive")
    M.windows(c)  # raises outside 1..16
    for name, t in (("px", px), ("py", py), ("scalars", scalars)):
        _expect(name, t, (n, NUM_LIMBS, b))
    _expect("pinf", pinf, (n, b), torch.bool)
    lib = load_kernels().lib
    scratch = torch.empty((max(lib.bn_msm_pippenger_scratch_bytes(n, c, b, chunk), 1),),
                          dtype=torch.uint8, device=px.device)
    return (px.contiguous(), py.contiguous(), pinf.to(torch.uint8).contiguous(),
            scalars.contiguous(), n, b, scratch)


def _affine_out(b: int, dev):
    ox = torch.empty((NUM_LIMBS, b), dtype=torch.int32, device=dev)
    return ox, torch.empty_like(ox), torch.empty((b,), dtype=torch.bool, device=dev)


def msm_pippenger(points, scalars, c: int = 8, chunk: int = PIPPENGER_CHUNK):
    """Per-lane bucket MSM sum_j scalars[j] * points[j] in affine form,
    kernel K6 (six launches on the current stream, counted as one call),
    for large point counts.

    points and scalars as ``msm_affine``'s, c the window width (1..16),
    chunk the entries a thread of the bucket stage takes. The digits,
    their counting sort, the bucket sums over chunks of all rows, the
    merge of split buckets, the window sums and the combine all run in
    K6 (csrc/pippenger.cuh); the wrapper allocates one scratch buffer and
    the window sums. Returns (x (16,B) int32, y (16,B) int32, inf (B,)
    bool); infinity is (0, 0, True)."""
    px, py, pinf = points
    if _on_cpu(px, py, pinf, scalars):
        return M.pippenger_plain(points, scalars, c)
    px, py, pinf8, scalars, n, b, scratch = _pippenger_args(points, scalars, c, chunk)
    wsum = torch.empty((b, M.windows(c), M.G1_WORDS), dtype=torch.int32, device=px.device)
    ox, oy, oinf = _affine_out(b, px.device)
    if b == 0:
        return ox, oy, oinf
    launch(ox.device, "bn_msm_pippenger", px.data_ptr(), py.data_ptr(), pinf8.data_ptr(),
           scalars.data_ptr(), n, c, chunk, scratch.data_ptr(), wsum.data_ptr(),
           ox.data_ptr(), oy.data_ptr(), oinf.data_ptr(), b)
    msm_pippenger.launches += 1
    return ox, oy, oinf


def msm_pippenger_windows(points, scalars, c: int = 8, chunk: int = PIPPENGER_CHUNK,
                          stage_ms=None):
    """K6 without its combine: each lane's window sums sum_j j * B_j,
    (B, W, 24) int32 words (ops/msm.py::to_words), for
    ``msm_pippenger_combine`` (parallel/sharded.py sums its ranks' window
    sums there). Its plain twin on CPU tensors. A launch counts in
    ``msm_pippenger.launches``. With a list ``stage_ms``, the five
    stages' ms by CUDA events (digits, sort, buckets, merge, reduction)
    are appended to it, after a sync."""
    px, py, pinf = points
    if _on_cpu(px, py, pinf, scalars):
        return M.window_sums_plain(points, scalars, c)
    px, py, pinf8, scalars, n, b, scratch = _pippenger_args(points, scalars, c, chunk)
    wsum = torch.empty((b, M.windows(c), M.G1_WORDS), dtype=torch.int32, device=px.device)
    if b == 0:
        return wsum
    ms = (ctypes.c_float * 5)()
    launch(px.device, "bn_msm_pippenger_windows", px.data_ptr(), py.data_ptr(),
           pinf8.data_ptr(), scalars.data_ptr(), n, c, chunk, scratch.data_ptr(),
           wsum.data_ptr(), b, ms if stage_ms is not None else None)
    msm_pippenger.launches += 1
    if stage_ms is not None:
        stage_ms.extend(ms)
    return wsum


def msm_pippenger_combine(wsums, c: int = 8):
    """K6's combine: the affine sum per lane of k sets of window sums
    wsums (k, B, W, 24) int32 words, added window by window, then Horner
    over the windows. Its plain twin on CPU tensors. A launch counts in
    ``msm_pippenger.launches``."""
    if _on_cpu(wsums):
        return M.combine_plain(wsums, c)
    k, b = wsums.shape[:2]
    if k < 1:
        raise ValueError("msm_pippenger_combine: needs at least one set of window sums")
    _expect("wsums", wsums, (k, b, M.windows(c), M.G1_WORDS))
    wsums = wsums.contiguous()
    ox, oy, oinf = _affine_out(b, wsums.device)
    if b == 0:
        return ox, oy, oinf
    launch(ox.device, "bn_msm_pippenger_combine", wsums.data_ptr(), k, c, ox.data_ptr(),
           oy.data_ptr(), oinf.data_ptr(), b)
    msm_pippenger.launches += 1
    return ox, oy, oinf


g2_on_curve.launches = 0
msm_affine.launches = 0
miller_mixed.launches = 0
final_exp.launches = 0
miller_product.launches = 0
msm_pippenger.launches = 0

__all__ = ["KERNEL_ENTRY_POINTS", "mont_mul", "g2_on_curve", "msm_affine", "miller_mixed",
           "final_exp", "miller_product", "msm_pippenger", "msm_pippenger_windows",
           "msm_pippenger_combine", "launch_counts", "reset_launch_counts"]


def pairing(p_affine, q_affine):
    """ops/pairing.py::pairing over K5 and K4."""
    return pairing_batch(tuple(t.unsqueeze(0) for t in p_affine),
                         tuple(t.unsqueeze(0) for t in q_affine))


def pairing_batch(pairs_p, pairs_q):
    """ops/pairing.py::pairing_batch: K5 over the pairs, then K4."""
    return final_exp(miller_product(pairs_p, pairs_q))


def pairing_batch_is_one(pairs_p, pairs_q):
    """ops/pairing.py::pairing_batch_is_one over K5 and K4."""
    gt = pairing_batch(pairs_p, pairs_q)
    return T.fq12_eq(gt, T.fq12_one(gt.shape[2:], gt))

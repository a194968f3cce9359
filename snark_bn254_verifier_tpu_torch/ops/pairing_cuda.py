"""Wrappers of the fused K1 and kernels K2-K5 (CUDA), and the port's
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

Each wrapper sends a CPU tensor to its plain twin and a CUDA tensor to
its kernel, checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on its tensors' device and that
device's current stream, raises on a CUDA error and counts its launches
in ``<wrapper>.launches``. No wrapper pads the batch: the kernels mask
the ragged edge. g2_on_curve runs one thread per lane; K2-K5 run on a team of threads per lane, at the shapes
csrc/msm.cuh (K2) and csrc/team.cuh (K3-K5) fix.
"""

from __future__ import annotations

import torch

from . import curve as C
from . import pairing as PR
from .field_cuda import launch, mont_mul
from .lines import STEPS
from .limbs import NUM_LIMBS

# Every kernel the port launches; tests/test_torch_kernel_registry.py
# holds it equal to the wrappers with a launch counter and to the phases
# of chip_smoke.py, so no kernel ships without an on-card check.
KERNEL_ENTRY_POINTS = ("mont_mul", "g2_on_curve", "msm_affine", "miller_mixed",
                       "final_exp", "miller_product")


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


g2_on_curve.launches = 0
msm_affine.launches = 0
miller_mixed.launches = 0
final_exp.launches = 0
miller_product.launches = 0

__all__ = ["KERNEL_ENTRY_POINTS", "mont_mul", "g2_on_curve", "msm_affine", "miller_mixed",
           "final_exp", "miller_product", "launch_counts", "reset_launch_counts"]

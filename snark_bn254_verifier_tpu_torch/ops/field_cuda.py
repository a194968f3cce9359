"""Wrapper of kernel K1, the batched Montgomery multiply (CUDA).

The counterpart of snark_bn254_verifier_tpu/ops/field_pallas.py
(``mont_mul_pallas``, kernel ``_mont_kernel`` at field_pallas.py:37). No
path launches it: the main path's G2 on-curve mask runs K1's products in
its fused form, ops/pairing_cuda.py::g2_on_curve. It stays as the
elementwise product, held against its plain twin on the card.

Dispatch: a CPU tensor goes to the plain twin (ops/field.py::mont_mul), a
CUDA tensor to the kernel; nothing falls back from one to the other.
``mont_mul.launches`` counts kernel launches.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from . import field as F
from .limbs import FieldSpec, NUM_LIMBS


def _check_limbs(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
    if t.dim() < 1 or t.shape[0] != NUM_LIMBS:
        raise ValueError(f"{name}: expected (16, *batch), got {tuple(t.shape)}")


@functools.lru_cache(maxsize=None)
def _raise_stack_limit(index: int) -> None:
    """Give the kernels' __noinline__ call chains their per-thread stack on
    device ``index`` (the runtime's current device when called)."""
    lib = _build.load_kernels().lib
    _build.check(lib, lib.bn_init(_build.STACK_BYTES), "bn_init")


def launch(dev: torch.device, entry: str, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and the current
    stream of ``dev``, with ``dev`` the runtime's current device (the
    kernels launch there), and raise on a CUDA error."""
    with torch.cuda.device(dev):
        lib = _build.load_kernels().lib
        _raise_stack_limit(torch.cuda.current_device())
        code = getattr(lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, code, entry)


def on_cpu(*tensors) -> bool:
    """True where every tensor lies on the CPU (the wrapper runs its plain
    twin), False where all lie on one CUDA device; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def expect(name: str, t: torch.Tensor, shape, dtype=torch.int32) -> None:
    """Raise unless ``t`` has this dtype and shape."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod p (or r) over (16, *batch) int32 limbs; the
    batch axes broadcast."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return F.mont_mul(spec, a, b)
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(f"mont_mul: tensors on {a.device} and {b.device}")
    _check_limbs("mont_mul a", a)
    _check_limbs("mont_mul b", b)
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = a.expand((NUM_LIMBS,) + batch).contiguous()
    b = b.expand((NUM_LIMBS,) + batch).contiguous()
    out = torch.empty_like(a)
    n = out[0].numel()
    if n == 0:
        return out
    field = 0 if spec.name == "fq" else 1
    launch(out.device, "bn_mont_mul", a.data_ptr(), b.data_ptr(), out.data_ptr(), n, field)
    mont_mul.launches += 1
    return out


mont_mul.launches = 0

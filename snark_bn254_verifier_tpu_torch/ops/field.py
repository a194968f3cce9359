"""Plain PyTorch Fq / Fr arithmetic on ``(16, *batch)`` limb tensors.

The counterpart of snark_bn254_verifier_tpu/ops/field.py. Every function
broadcasts over the trailing batch axes, keeps its first argument's dtype
(``torch.int32`` at the port's boundary) and computes in ``torch.int64``:
PyTorch on the CPU has no uint32 add, shift or compare, and 16-bit limbs
keep every product below 2^32 and every column sum far below 2^63.

Every result is fully reduced into [0, modulus), as the JAX package's
are, so equal values have equal limbs. These functions are the plain
twin of kernel K1 (csrc/kernels.cu::mont_mul_kernel) and the arithmetic
under the plain twins of K2-K5; the CPU tests hold them against the JAX
package and the oracle.

Carry chains are resolved without a Python loop over limbs: a carry out
of limb i is decided by the highest limb at or below i that does not
merely pass its incoming carry on, which ``torch.cummax`` finds for all
limbs at once (``_ripple``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F_nn

from .limbs import FQ, FR, LIMB_BITS, LIMB_MASK, NUM_LIMBS, FieldSpec

L = NUM_LIMBS
_I64 = torch.int64

__all__ = ["FQ", "FR", "FieldSpec"]


@functools.lru_cache(maxsize=None)
def _limb_const(key: str, device: torch.device) -> torch.Tensor:
    """(16,) int64 constant limbs on ``device`` (cached: a host->device copy
    per call would dominate a small op on the card)."""
    spec = FQ if key.startswith("fq") else FR
    np_limbs = {
        "mod": spec.mod_limbs,
        "one": spec.one_mont_np,
    }[key.split(":")[1]]
    return torch.as_tensor(np_limbs, dtype=_I64, device=device)


def _const(spec: FieldSpec, which: str, like: torch.Tensor) -> torch.Tensor:
    """Constant limbs shaped (16, 1, ...) to broadcast against ``like``."""
    c = _limb_const(f"{spec.name}:{which}", like.device)
    return c.view((L,) + (1,) * (like.dim() - 1))


@functools.lru_cache(maxsize=None)
def _limb_index(ndim: int, device: torch.device) -> torch.Tensor:
    return torch.arange(L, dtype=_I64, device=device).view((L,) + (1,) * (ndim - 1))


def _ripple(gen: torch.Tensor, prop: torch.Tensor):
    """Resolve a carry (or borrow) chain along the limb axis.

    Limb i generates a carry where ``gen`` is 1, passes its incoming carry
    on where ``prop`` is true, and stops it otherwise. Returns the carry
    into every limb and the carry out of the top limb (int64 0/1)."""
    idx = _limb_index(gen.dim(), gen.device)
    last = torch.cummax(torch.where(prop, -1, idx), dim=0).values
    out = torch.gather(gen, 0, last.clamp(min=0)) * (last >= 0)
    cin = torch.cat([torch.zeros_like(out[:1]), out[:-1]])
    return cin, out[-1]


def _add_raw(a, b):
    """Limb-wise a + b with exact carries: (sum mod 2^256, carry out)."""
    s = a + b
    cin, cout = _ripple(s >> LIMB_BITS, s == LIMB_MASK)
    return (s + cin) & LIMB_MASK, cout


def _sub_raw(a, b):
    """Limb-wise a - b with exact borrows: (diff mod 2^256, borrow out)."""
    d = a - b
    bin_, bout = _ripple((d < 0).to(_I64), d == 0)
    return (d - bin_) & LIMB_MASK, bout


def _cond_sub_mod(spec: FieldSpec, t, extra):
    """t - modulus where the value t + extra * 2^256 is >= modulus, else t.
    The value must be below twice the modulus."""
    d, borrow = _sub_raw(t, _const(spec, "mod", t))
    do_sub = (extra != 0) | (borrow == 0)
    return torch.where(do_sub.unsqueeze(0), d, t)


def add(spec: FieldSpec, a, b):
    """(a + b) mod modulus."""
    s, carry = _add_raw(a.to(_I64), b.to(_I64))
    return _cond_sub_mod(spec, s, carry).to(a.dtype)


def sub(spec: FieldSpec, a, b):
    """(a - b) mod modulus."""
    d, borrow = _sub_raw(a.to(_I64), b.to(_I64))
    out, _ = _add_raw(d, _const(spec, "mod", d) * borrow.unsqueeze(0))
    return out.to(a.dtype)


def neg(spec: FieldSpec, a):
    """(-a) mod modulus; zero stays zero."""
    return sub(spec, torch.zeros_like(a), a)




def mont_mul(spec: FieldSpec, a, b):
    """Montgomery product a * b * 2^-256 mod modulus, fully reduced.

    The plain twin of kernel K1 and of the Pallas kernel
    snark_bn254_verifier_tpu/ops/field_pallas.py::_mont_kernel. The 256
    partial products are summed into their columns by a skewed view; the
    reduction then runs limb by limb with deferred column carries (as
    ops/field.py::mont_mul of the JAX package does), followed by carry
    normalisation and one conditional subtraction."""
    dtype = a.dtype
    a64, b64 = a.to(_I64), b.to(_I64)
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    prod = a64.unsqueeze(1) * b64.unsqueeze(0)  # (16, 16, *batch), < 2^32
    prod = prod.expand((L, L) + batch).reshape(L, L, -1)
    n = prod.shape[2]
    # Skew row i right by i: padded to 2L columns and read back with row
    # stride 2L - 1, entry (i, j) lands in column i + j.
    skew = F_nn.pad(prod, (0, 0, 0, L)).reshape(2 * L * L, n)
    cols = skew[: L * (2 * L - 1)].view(L, 2 * L - 1, n).sum(0)  # < 2^36
    t = F_nn.pad(cols, (0, 0, 0, 2))  # (2L + 1, n)
    mod = _limb_const(f"{spec.name}:mod", a.device).view(L, 1)
    for i in range(L):
        m = ((t[i] & LIMB_MASK) * spec.n0inv) & LIMB_MASK
        t[i : i + L].add_(m * mod)
        t[i + 1].add_(t[i] >> LIMB_BITS)  # column i is now 0 mod 2^16
    r = t[L:]
    for _ in range(3):  # columns < 2^38 -> every limb <= 2^16
        c = r[:-1] >> LIMB_BITS
        r[:-1].bitwise_and_(LIMB_MASK)
        r[1:].add_(c)
    cin, cout = _ripple(r[:L] >> LIMB_BITS, r[:L] == LIMB_MASK)
    limbs = (r[:L] + cin) & LIMB_MASK
    out = _cond_sub_mod(spec, limbs, r[L] + cout)
    return out.reshape((L,) + batch).to(dtype)


def mont_sq(spec: FieldSpec, a):
    return mont_mul(spec, a, a)


def is_zero(a):
    return (a == 0).all(dim=0)


def eq(a, b):
    return (a == b).all(dim=0)


def select(cond, a, b):
    """cond has the batch shape; leading limb/component axes broadcast."""
    extra = a.dim() - cond.dim()
    return torch.where(cond.view((1,) * extra + tuple(cond.shape)), a, b)


def one_mont(spec: FieldSpec, like):
    return _const(spec, "one", like).to(like.dtype).expand(like.shape)






def pow_const(spec: FieldSpec, a, exponent: int):
    """a^exponent (Montgomery in and out) for a fixed Python-int exponent:
    square-and-multiply over its bits, most significant first."""
    acc = one_mont(spec, a)
    for bit in bin(exponent)[2:]:
        acc = mont_sq(spec, acc)
        if bit == "1":
            acc = mont_mul(spec, acc, a)
    return acc


def inv(spec: FieldSpec, a):
    """Fermat inversion a^(modulus-2); zero maps to zero."""
    return pow_const(spec, a, spec.modulus - 2)


def fq_add(a, b):
    return add(FQ, a, b)


def fq_sub(a, b):
    return sub(FQ, a, b)


def fq_neg(a):
    return neg(FQ, a)


def fq_mul(a, b):
    return mont_mul(FQ, a, b)


def fq_sq(a):
    return mont_mul(FQ, a, a)


def fq_inv(a):
    return inv(FQ, a)

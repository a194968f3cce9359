"""Limb layout and per-field constants of the PyTorch port.

Field elements cross every public function of the port as ``(16, *batch)``
tensors of 16-bit limbs, least significant first, in ``torch.int32`` —
the layout of the JAX package (snark_bn254_verifier_tpu/ops/limbs.py), so
the tests compare like with like. Inside a CUDA kernel the same value is
held as 8 limbs of 32 bits; Montgomery's R = 2^256 is the same for both
limb widths, so converting at load and store is exact.

``FieldSpec`` is the counterpart of ops/field.py:42-72 of the JAX package
(that module imports JAX). Every constant is recomputed here from the
oracle's moduli; none is typed by hand.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..oracle import bn254 as bn

LIMB_BITS = 16
NUM_LIMBS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
TOTAL_BITS = LIMB_BITS * NUM_LIMBS  # 256
WORD_BITS = 32
NUM_WORDS = TOTAL_BITS // WORD_BITS  # 8: the CUDA kernels' limb count


def int_to_limbs(value: int) -> np.ndarray:
    """Python int -> int32[16] little-endian 16-bit limbs."""
    if value < 0 or value >= 1 << TOTAL_BITS:
        raise ValueError("value out of range for 256-bit limbs")
    return np.array(
        [(value >> (LIMB_BITS * i)) & LIMB_MASK for i in range(NUM_LIMBS)],
        dtype=np.int32,
    )


def ints_to_limbs_batch(values: Sequence[int]) -> np.ndarray:
    """[ints] -> int32[16, B] (limb axis leading)."""
    if len(values) == 0:
        return np.zeros((NUM_LIMBS, 0), dtype=np.int32)
    return np.stack([int_to_limbs(v) for v in values], axis=1)


def limbs_batch_to_ints(limbs) -> list:
    """(16, *batch) limbs -> flat list of ints (batch in C order)."""
    arr = np.asarray(limbs, dtype=np.int64)
    if arr.shape[0] != NUM_LIMBS:
        raise ValueError(f"expected {NUM_LIMBS} limbs, got {arr.shape[0]}")
    flat = arr.reshape(NUM_LIMBS, -1)
    return [
        sum(int(flat[i, j]) << (LIMB_BITS * i) for i in range(NUM_LIMBS))
        for j in range(flat.shape[1])
    ]


def int_to_words(value: int, nwords: int = NUM_WORDS) -> list:
    """Python int -> little-endian list of 32-bit words (kernel constants)."""
    return [(value >> (WORD_BITS * i)) & 0xFFFFFFFF for i in range(nwords)]


class FieldSpec:
    """Static per-field constants, derived from the modulus alone."""

    def __init__(self, modulus: int, name: str):
        self.modulus = modulus
        self.name = name
        self.mod_limbs = int_to_limbs(modulus)
        r = 1 << TOTAL_BITS
        self.r_mod = r % modulus
        self.r2 = (r * r) % modulus
        self.r_inv = pow(self.r_mod, -1, modulus)
        # -modulus^-1 mod 2^16 (plain CIOS digit) and mod 2^32 (kernel CIOS)
        self.n0inv = (-pow(modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        self.n0inv32 = (-pow(modulus, -1, 1 << WORD_BITS)) % (1 << WORD_BITS)
        self.one_mont_np = int_to_limbs(self.r_mod)

    def to_mont_int(self, v: int) -> int:
        return ((v % self.modulus) << TOTAL_BITS) % self.modulus

    def from_mont_int(self, v: int) -> int:
        return v * self.r_inv % self.modulus

    def pack(self, values: Sequence[int], mont: bool = True) -> np.ndarray:
        """Host: list of ints -> (16, B) int32 limbs (Montgomery by default)."""
        return ints_to_limbs_batch(
            [self.to_mont_int(v) if mont else v % self.modulus for v in values]
        )

    def pack_scalar(self, v: int, mont: bool = True) -> np.ndarray:
        return int_to_limbs(self.to_mont_int(v) if mont else v % self.modulus)

    def unpack(self, limbs, mont: bool = True) -> list:
        """(16, *batch) limbs -> flat list of field ints."""
        vals = limbs_batch_to_ints(limbs)
        return [self.from_mont_int(v) for v in vals] if mont else vals


FQ = FieldSpec(bn.P, "fq")
FR = FieldSpec(bn.R, "fr")

"""Host packing between oracle values and the port's limb arrays (numpy).

The counterpart of snark_bn254_verifier_tpu/models/jax_backend.py:37-100:
G1 points become (x (16, B), y (16, B), inf (B,)), G2 points Fq2
coordinates (16, 2, B), Fq12 values (16, 12, B) with component
6h + 2j + c. Arrays are int32 Montgomery limbs except the canonical Fr
scalars. A device result comes back to the host in one copy: a G1 point's
x, y and infinity flag are stacked on the device first (``unpack_g1``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.limbs import FQ, FR, NUM_LIMBS
from ..utils import native


def packer() -> str:
    """The Fq packer ``pack_fq`` runs: "native" (Montgomery form in C,
    utils/native.py::pack_be_batch) where the host library loads, else
    "bytes" (ops/limbs.py::FieldSpec.pack)."""
    return "native" if native.native_available() else "bytes"


def pack_fq(values: Sequence[int]) -> np.ndarray:
    """Fq ints -> (16, B) int32 Montgomery limbs."""
    if len(values) and native.native_available():
        try:
            buf = b"".join([int(v).to_bytes(32, "big") for v in values])
        except OverflowError:  # negative or wider than 256 bits: reduce first
            return FQ.pack(values)
        return native.pack_be_batch(buf, len(values))[0].astype(np.int32)
    return FQ.pack(values)


def pack_fr_canonical(values: Sequence[int]) -> np.ndarray:
    return FR.pack(values, mont=False)


def pack_fr_columns(cols, n: int, b: int) -> np.ndarray:
    """n Fr ints a lane (None: a lane without them, all zero) -> (n, 16, b)
    canonical limbs (each value mod r), in one packer call."""
    flat = [0] * (n * b)
    for lane, col in enumerate(cols):
        if col is not None:
            flat[lane::b] = [v % FR.modulus for v in col]
    return np.ascontiguousarray(pack_fr_canonical(flat).reshape(16, n, b).swapaxes(0, 1))


def unpack_fq(arr) -> List[int]:
    return FQ.unpack(np.asarray(arr))


def pack_g1(points) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Oracle G1 points (None = infinity) -> affine (x, y, inf) arrays;
    every coordinate in one ``pack_fq`` call."""
    n = len(points)
    xy = pack_fq([p[0] if p is not None else 0 for p in points]
                 + [p[1] if p is not None else 0 for p in points])
    inf = np.asarray([p is None for p in points], dtype=bool).reshape(n)
    return np.ascontiguousarray(xy[:, :n]), np.ascontiguousarray(xy[:, n:]), inf


def pack_g2(points) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Oracle G2 points -> affine (x (16, 2, B), y (16, 2, B), inf); every
    coordinate in one ``pack_fq`` call."""
    n = len(points)
    coords = pack_fq([p[i][c] if p is not None else 0
                      for i in range(2) for c in range(2) for p in points])
    coords = coords.reshape(NUM_LIMBS, 2, 2, n)
    inf = np.asarray([p is None for p in points], dtype=bool).reshape(n)
    return np.ascontiguousarray(coords[:, 0]), np.ascontiguousarray(coords[:, 1]), inf


def pair_major(pack, lanes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-pair lane lists of oracle points (``lanes[j][k]``: point j of
    lane k) -> pair-major (x, y, inf) arrays through ``pack`` (``pack_g1``
    or ``pack_g2``), the layout of the MSM and Miller-product kernels and
    of the JAX package's backend (jax_backend.py:162-163, :181-193):
    G1 (n,16,B), (n,16,B), (n,B); G2 (n,16,2,B), (n,16,2,B), (n,B)."""
    packed = [pack(lane) for lane in lanes]
    return tuple(np.stack([a[i] for a in packed]) for i in range(3))


def pack_msm(points, scalars):
    """One MSM's oracle points and Fr scalars -> the MSM kernels' layout at
    batch one: ((x (N,16,1), y (N,16,1), inf (N,1)), scalars (N,16,1))."""
    x, y, inf = pack_g1(points)
    sc = pack_fr_canonical([s % FR.modulus for s in scalars])
    return ((np.ascontiguousarray(x.T[..., None]), np.ascontiguousarray(y.T[..., None]),
             inf[:, None]), np.ascontiguousarray(sc.T[..., None]))


def unpack_g1(x: torch.Tensor, y: torch.Tensor, inf: torch.Tensor) -> List:
    """Affine device result (x (16, B), y (16, B), inf (B,)) -> oracle
    points (None = infinity), with one device-to-host copy: x, y and the
    flags stacked as one (33, B) tensor on the device first."""
    return g1_from_rows(g1_rows(x, y, inf).cpu().numpy())


def g1_rows(x: torch.Tensor, y: torch.Tensor, inf: torch.Tensor) -> torch.Tensor:
    """``unpack_g1``'s (33, B) tensor on the device: x, y, the flags."""
    return torch.cat([x, y, inf.to(x.dtype).unsqueeze(0)])


def g1_from_rows(both: np.ndarray) -> List:
    """``g1_rows``' array on the host -> oracle points (None = infinity)."""
    b = both.shape[-1]
    xy = unpack_fq(both[:32].reshape(2, NUM_LIMBS, b).transpose(1, 0, 2))
    return [None if both[32, k] else (xy[k], xy[b + k]) for k in range(b)]


def pack_fq12(values) -> np.ndarray:
    """Oracle Fq12 tuples -> (16, 12, B) Montgomery limbs."""
    comps = pack_fq([v[h][j][c] for h in range(2) for j in range(3) for c in range(2)
                     for v in values])
    return comps.reshape(NUM_LIMBS, 12, len(values))


def unpack_fq12(x) -> List:
    """(16, 12, B) limbs -> list of oracle Fq12 tuples."""
    x = np.asarray(x)
    b = x.shape[-1]
    flat = unpack_fq(x)  # component c of lane k at c * B + k

    def comp(c, k):
        return flat[c * b + k]

    return [
        tuple(
            tuple((comp(6 * h + 2 * j, k), comp(6 * h + 2 * j + 1, k)) for j in range(3))
            for h in range(2)
        )
        for k in range(b)
    ]

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

from ..ops.limbs import FQ, FR


def pack_fq(values: Sequence[int]) -> np.ndarray:
    return FQ.pack(values)


def pack_fr_canonical(values: Sequence[int]) -> np.ndarray:
    return FR.pack(values, mont=False)


def unpack_fq(arr) -> List[int]:
    return FQ.unpack(np.asarray(arr))


def pack_g1(points) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Oracle G1 points (None = infinity) -> affine (x, y, inf) arrays."""
    xs = [p[0] if p is not None else 0 for p in points]
    ys = [p[1] if p is not None else 0 for p in points]
    inf = np.asarray([p is None for p in points], dtype=bool)
    return pack_fq(xs), pack_fq(ys), inf


def pack_g2(points) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Oracle G2 points -> affine (x (16, 2, B), y (16, 2, B), inf)."""

    def coord(i, c):
        return pack_fq([p[i][c] if p is not None else 0 for p in points])

    inf = np.asarray([p is None for p in points], dtype=bool)
    return (
        np.stack([coord(0, 0), coord(0, 1)], 1),
        np.stack([coord(1, 0), coord(1, 1)], 1),
        inf,
    )


def pair_major(pack, lanes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-pair lane lists of oracle points (``lanes[j][k]``: point j of
    lane k) -> pair-major (x, y, inf) arrays through ``pack`` (``pack_g1``
    or ``pack_g2``), the layout of the MSM and Miller-product kernels and
    of the JAX package's backend (jax_backend.py:162-163, :181-193):
    G1 (n,16,B), (n,16,B), (n,B); G2 (n,16,2,B), (n,16,2,B), (n,B)."""
    packed = [pack(lane) for lane in lanes]
    return tuple(np.stack([a[i] for a in packed]) for i in range(3))


def unpack_g1(x: torch.Tensor, y: torch.Tensor, inf: torch.Tensor) -> List:
    """Affine device result (x (16, B), y (16, B), inf (B,)) -> oracle
    points (None = infinity), with one device-to-host copy."""
    both = torch.cat([x, y, inf.to(x.dtype).unsqueeze(0)]).cpu().numpy()
    xs, ys = unpack_fq(both[:16]), unpack_fq(both[16:32])
    return [None if both[32, k] else (xs[k], ys[k]) for k in range(len(xs))]


def pack_fq12(values) -> np.ndarray:
    """Oracle Fq12 tuples -> (16, 12, B) Montgomery limbs."""
    comps = [
        pack_fq([v[h][j][c] for v in values])
        for h in range(2) for j in range(3) for c in range(2)
    ]
    return np.stack(comps, 1)


def unpack_fq12(x) -> List:
    """(16, 12, B) limbs -> list of oracle Fq12 tuples."""
    x = np.asarray(x)
    comps = [unpack_fq(x[:, c]) for c in range(12)]
    return [
        tuple(
            tuple((comps[6 * h + 2 * j][k], comps[6 * h + 2 * j + 1][k])
                  for j in range(3))
            for h in range(2)
        )
        for k in range(x.shape[-1])
    ]

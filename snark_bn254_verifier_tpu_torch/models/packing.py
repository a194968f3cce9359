"""Host packing between oracle values and the port's limb arrays (numpy).

The counterpart of snark_bn254_verifier_tpu/models/jax_backend.py:37-100:
G1 points become (x (16, B), y (16, B), inf (B,)), G2 points Fq2
coordinates (16, 2, B), Fq12 values (16, 12, B) with component
6h + 2j + c. Arrays are int32 Montgomery limbs except the canonical Fr
scalars. Results come back to the host in one copy per array.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

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

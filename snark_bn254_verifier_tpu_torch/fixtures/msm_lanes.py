"""Seeded MSM data with a closed-form answer, for the large MSM (ops/msm.py)
and the sharded one (parallel/sharded.py): shared by their tests and
chip_smoke.py, each at its own size and seed."""

from __future__ import annotations

import numpy as np

from ..oracle import bn254 as bn


def trapdoor_msm(n: int, seed: int):
    """(points, scalars, expected): n points P_i = (k0 + i) G, made by
    successive additions, and 31-byte scalars s_i, both from numpy's
    ``default_rng(seed)``, with their MSM in closed form, sum s_i P_i =
    (sum s_i (k0 + i)) G. The JAX package draws the same data for its MSM
    bench (bench.py:262-272, seed 11) and its two-process test
    (tests/dist_worker.py:50-62, seed 23)."""
    rng = np.random.default_rng(seed)
    k0 = int(rng.integers(1, 1 << 62))
    points, acc = [], bn.g1_mul(bn.G1_GEN, k0)
    for _ in range(n):
        points.append(acc)
        acc = bn.g1_add(acc, bn.G1_GEN)
    scalars = [int.from_bytes(rng.bytes(31), "big") % bn.R for _ in range(n)]
    expected = bn.g1_mul(bn.G1_GEN, sum(s * (k0 + i) for i, s in enumerate(scalars)) % bn.R)
    return points, scalars, expected

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


# The edge lanes of ``fixed_base_lanes``, lane by lane from lane 0.
FIXED_BASE_EDGES = ("zero", "k0_one", "r_minus_1", "top_window", "cancels", "doubles")


def fixed_base_lanes(n: int, b: int, seed: int):
    """(points, scalars, logs) of a fixed-base MSM over b lanes: n points
    P_j = k_j G that every lane shares, the last at infinity (k = 0), and
    a scalar a point in each lane, from ``random.Random(seed)``; each
    lane's sum is (sum_j s_j k_j) G, with logs the k_j. The first lanes
    are the edges of FIXED_BASE_EDGES as far as b reaches: every scalar
    zero; scalar 1 on P_0 alone (the Groth16 batch's k0); every scalar
    r - 1; scalars with a digit in the top 8-bit window (bits 248-253);
    s_0 P_0 + s_1 P_1 = 0 (the sum is infinity); s_0 P_0 = s_1 P_1 (the
    parts may meet as equal points). The rest are random."""
    import random

    rng = random.Random(seed)
    logs = [rng.randrange(1, bn.R) for _ in range(n - 1)] + [0]
    points = [bn.g1_mul(bn.G1_GEN, k) if k else None for k in logs]
    scalars = [[rng.randrange(bn.R) for _ in range(b)] for _ in range(n)]
    k0, k1 = logs[0], logs[1 % n]
    edges = {
        "zero": [0] * n,
        "k0_one": [1] + [0] * (n - 1),
        "r_minus_1": [bn.R - 1] * n,
        "top_window": [(0x2F << 248) | (j + 1) for j in range(n)],
        "cancels": [(-k1 * pow(k0, -1, bn.R)) % bn.R, 1] + [0] * (n - 2),
        "doubles": [k1 * pow(k0, -1, bn.R) % bn.R, 1] + [0] * (n - 2),
    }
    for lane, name in enumerate(FIXED_BASE_EDGES[:b]):
        for j in range(n):
            scalars[j][lane] = edges[name][j]
    return points, scalars, logs

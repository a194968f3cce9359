"""Seeded lanes of the G2 on-curve mask (ops/pairing_cuda.py::g2_on_curve):
every kind of lane the mask must tell apart, packed as the batch verifier
hands them to it, with the oracle's answer. Shared by the mask's tests and
chip_smoke.py, each with its own seed and size."""

from __future__ import annotations

import numpy as np

from ..models.packing import pack_g2
from ..oracle import bn254 as bn

KINDS = (
    "on",           # a point of the curve
    "off",          # y moved off the curve
    "inf",          # the point at infinity: zero coordinates, flag set
    "inf_flag",     # the flag set over off-curve coordinates
    "invalid",      # on the curve, valid False
    "off_invalid",  # off the curve and valid False
    "random",       # random coordinates below p
)
# half the lanes on the curve, the others divergent
P_KIND = (0.5, 0.1, 0.1, 0.1, 0.1, 0.05, 0.05)


def g2_mask_lanes(seed: int, n: int, head=KINDS):
    """n lanes, the first of the kinds in ``head`` (cut to n), the rest
    drawn with numpy from P_KIND. Returns x, y (16, 2, n) int32 Montgomery
    limbs, inf and valid (n,) bool arrays, and the oracle's
    valid && (inf || y^2 == x^3 + b') per lane as a list."""
    rng = np.random.default_rng(seed)
    pool = [bn.g2_mul(bn.G2_GEN, int(k)) for k in rng.integers(1, 1 << 62, size=4)]
    kinds = list(head[:n]) + [KINDS[k] for k in rng.choice(len(KINDS), n - len(head[:n]), p=P_KIND)]
    pts, inf, valid = [], np.zeros(n, dtype=bool), np.ones(n, dtype=bool)
    for lane, kind in enumerate(kinds):
        x, y = pool[int(rng.integers(0, len(pool)))]
        if kind in ("off", "inf_flag", "off_invalid"):
            y = bn.fq2_add(y, (int(rng.integers(1, 1 << 30)), 0))
        elif kind == "random":
            x, y = ((int.from_bytes(rng.bytes(32), "little") % bn.P,
                     int.from_bytes(rng.bytes(32), "little") % bn.P) for _ in range(2))
        pts.append(None if kind == "inf" else (x, y))
        inf[lane] = kind in ("inf", "inf_flag")
        valid[lane] = kind not in ("invalid", "off_invalid")
    x, y, _ = pack_g2(pts)
    want = [bool(v and (i or bn.g2_is_on_curve(p))) for v, i, p in zip(valid, inf, pts)]
    return x, y, inf, valid, want

"""The comparison that decides ``correct``.

The answers are verdicts, one a proof, which can be checked one by one.
After the window has closed every verdict the window produced is
compared with the label the generator gave its proof (valid by
construction, or one of the fault kinds), and a sample of pool items,
drawn from the seed with one item of every fault kind in the window
among them, is verified again by the plain reference
(verify_bench/reference/) from the bytes and inputs alone; every verdict
the window gave one of those items is compared with the reference's.
The reference also judges the labels of its sample, so a generator at
fault shows too. Each number is exact, so each limit is 0:

- ``label_mismatch``: verdicts that differ from their proof's label;
- ``missing``: proofs sent in the window with no verdict (a batch whose
  verdicts have another shape counts every lane);
- ``ref_mismatch``: verdicts of sampled items that differ from the
  reference's;
- ``ref_label_mismatch``: sampled items whose label the reference
  contradicts.
"""

from __future__ import annotations

import importlib
import random
import time

import numpy as np

LIMITS = {"label_mismatch": 0, "missing": 0, "ref_mismatch": 0, "ref_label_mismatch": 0}


def sample(pool, seen: np.ndarray, size: int, seed: int) -> list:
    """Pool indexes the reference verifies: one of every kind among the
    ``seen`` items, then valid ones, ``size`` in all, drawn from ``seed``."""
    rng = random.Random(f"check/{seed}")
    by_kind = {}
    for i in np.flatnonzero(seen).tolist():
        by_kind.setdefault(pool.kinds[i], []).append(i)
    picked = [rng.choice(v) for k, v in sorted(by_kind.items()) if k != "valid"]
    valid = by_kind.get("valid", [])
    picked += rng.sample(valid, min(len(valid), max(size - len(picked), 0)))
    return sorted(picked)


def judge(cfg: dict, traffic: dict, pool, records, seed: int) -> dict:
    """``records``: (pool indexes, verdicts or None) for every batch or call
    of the window. Returns {name: (value, limit)}, the reference's seconds
    and the count of verdicts compared."""
    n = len(pool.proofs)
    seen = np.zeros(n, dtype=bool)
    label_mismatch = missing = 0
    answered = []
    for idx, got in records:
        idx = np.asarray(idx)
        seen[idx] = True
        if got is None or np.shape(got) != idx.shape:
            missing += idx.size
            continue
        got = np.asarray(got, dtype=bool)
        label_mismatch += int((got != pool.labels[idx]).sum())
        answered.append((idx, got))
    t = time.perf_counter()
    ref = importlib.import_module(f"{__package__}.reference.{cfg['protocol']}")
    verify = ref.verifier(pool.vk, seed)
    want = np.full(n, -1, dtype=np.int8)  # the reference's verdict of each sampled item
    for i in sample(pool, seen, traffic["check_sample"], seed):
        want[i] = verify(pool.proofs[i], pool.inputs[i])
    sampled = want >= 0
    ref_label = int((want[sampled] != pool.labels[sampled]).sum())
    ref_mismatch = checked = 0
    for idx, got in answered:
        w = want[idx]
        m = w >= 0
        checked += int(m.sum())
        ref_mismatch += int((got[m] != w[m].astype(bool)).sum())
    numbers = {"label_mismatch": label_mismatch, "missing": missing,
               "ref_mismatch": ref_mismatch, "ref_label_mismatch": ref_label}
    return {"numbers": {k: (v, LIMITS[k]) for k, v in numbers.items()},
            "reference_s": time.perf_counter() - t, "ref_compared": checked}


def correct(result: dict) -> bool:
    return all(v <= lim for v, lim in result["numbers"].values())

"""Runner ``batch_async``: a closed loop of batches through the protocol's
batch verifier (parallel/batch.py's Groth16BatchVerifier or
PlonkBatchVerifier), ``verify_batch_async`` with at most ``in_flight``
batches in flight beyond the one being read, as the port's bench loop and
the README do: dispatch batch n, then read batch n - in_flight's
verdicts with ``.cpu()``.

Per batch it records the dispatch's host time, the verifier's host
stages (``last_stats.extra["host_s"]``) and the latency from the
dispatch to the verdicts on the host; per window the proofs verdicted
and the time from the first dispatch to the last verdict.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

WARMUP = 4  # batches before the window: both streams of the verifier's ring, twice


def system(cfg: dict, vk: bytes):
    """The program under test: the protocol's batch verifier on the card."""
    from snark_bn254_verifier_tpu_torch import Groth16BatchVerifier, PlonkBatchVerifier

    cls = {"groth16": Groth16BatchVerifier, "plonk": PlonkBatchVerifier}[cfg["protocol"]]
    return cls(vk, device="cuda")


def _verdicts(ok) -> np.ndarray:
    return np.asarray(ok.cpu() if hasattr(ok, "cpu") else ok)


def loop(ver, pool, traffic: dict, orders, tracer, seconds: float = 0.0,
         count: int = 0) -> dict:
    """Run batches until ``seconds`` have passed (or ``count`` batches are
    dispatched), then read the ones still in flight."""
    size, depth = traffic["batch"], traffic["in_flight"]
    rec = {"records": [], "latency_s": [], "dispatch_s": [], "host_stage_s": []}
    pending = deque()

    def read_oldest():
        idx, t_sent, ok = pending.popleft()
        with tracer.span("vb.read"):
            got = _verdicts(ok)
        rec["latency_s"].append(time.perf_counter() - t_sent)
        rec["records"].append((idx, got))

    t0 = time.perf_counter()
    end = t0 + seconds
    sent = 0
    while (sent < count) if count else (time.perf_counter() < end):
        idx = orders.batch(size)
        proofs = [pool.proofs[i] for i in idx]
        inputs = [pool.inputs[i] for i in idx]
        t = time.perf_counter()
        with tracer.span("vb.dispatch"):
            ok = ver.verify_batch_async(proofs, inputs)
        rec["dispatch_s"].append(time.perf_counter() - t)
        rec["host_stage_s"].append(ver.last_stats.extra["host_s"])
        pending.append((idx, t, ok))
        sent += 1
        if len(pending) > depth:
            read_oldest()
    while pending:
        read_oldest()
    rec["window_s"] = time.perf_counter() - t0
    rec["lanes"] = sent * size
    return rec

"""Runner ``single``: a closed loop of one caller verifying one proof a
call through the protocol's facade (models/groth16.py's
``Groth16Verifier.verify`` or models/plonk.py's ``PlonkVerifier.verify``
on the card), walking through successive permutations of the pool. A
call that raises one of the port's verification errors (the reference's
error taxonomy, utils/errors.py) is a rejection; one that raises a
ValueError, TypeError, IndexError, KeyError or struct.error gives no
verdict (counted by the check as missing, tallied by type under
``raised``); anything else fails the run.

Per call it records the latency; per window the calls made and the time
from the first call's start to the last call's end.
"""

from __future__ import annotations

import struct
import time

import numpy as np

WARMUP = 16  # calls before the window: every shape a call uses, built and loaded


def system(cfg: dict, vk: bytes):
    """The program under test: ``verify(proof, inputs) -> bool`` through
    the protocol's facade on the card."""
    from snark_bn254_verifier_tpu_torch import Groth16Verifier, PlonkVerifier
    from snark_bn254_verifier_tpu_torch.utils.errors import VerifierError

    facade = {"groth16": Groth16Verifier, "plonk": PlonkVerifier}[cfg["protocol"]]

    def verify(proof: bytes, inputs):
        try:
            return bool(facade.verify(proof, vk, inputs, device="cuda"))
        except VerifierError:
            return False
        except (ValueError, TypeError, IndexError, KeyError, struct.error) as e:
            return Untyped(e)

    return verify


class Untyped:
    """A call that raised outside the port's error taxonomy: no verdict."""

    def __init__(self, error: Exception):
        self.name = type(error).__name__



def loop(verify, pool, traffic: dict, orders, tracer, seconds: float = 0.0,
         count: int = 0) -> dict:
    """Call until ``seconds`` have passed (or ``count`` calls are made)."""
    rec = {"records": [], "latency_s": [], "raised": {}}
    order, at = orders.batch(len(pool.proofs)), 0
    t0 = time.perf_counter()
    end = t0 + seconds
    calls = 0
    while (calls < count) if count else (time.perf_counter() < end):
        if at == len(order):
            order, at = orders.batch(len(pool.proofs)), 0
        i = int(order[at])
        at += 1
        t = time.perf_counter()
        with tracer.span("vb.call"):
            got = verify(pool.proofs[i], pool.inputs[i])
        rec["latency_s"].append(time.perf_counter() - t)
        if isinstance(got, Untyped):
            rec["raised"][got.name] = rec["raised"].get(got.name, 0) + 1
            got = None
        rec["records"].append((np.array([i]), None if got is None else np.array([got])))
        calls += 1
    rec["window_s"] = time.perf_counter() - t0
    rec["lanes"] = calls
    return rec

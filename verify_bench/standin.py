"""The plain reference put in the program's place, for the control and the
fault tests of the comparison that decides ``correct``.

``system(cfg, vk)`` factories shaped as a runner's own: for ``batch_async``
an object with ``verify_batch_async(proofs, inputs)`` and ``last_stats``,
for ``single`` a ``verify(proof, inputs) -> bool``. Their verdicts are the
reference's (verify_bench/reference/), computed once a distinct (proof,
inputs) pair, optionally in worker processes beforehand (``precompute``).

- ``canonical=False`` is the control: the reference with one guarantee
  of the configuration broken, a non-canonical coordinate or scalar
  reduced instead of refused.
- ``fault`` breaks the timed path as a program at fault would:
  ``unchanged`` (each call hands back the previous call's verdicts, its
  state unchanged), ``half`` (the second half of each batch left out and
  reported valid, or every second single call), ``dropped`` (verdicts for
  half the batch only, or none for every second call), ``altered`` (one
  verdict of each batch flipped where it is produced, or every seventh
  single call's).
"""

from __future__ import annotations

import functools
import importlib
import multiprocessing
from types import SimpleNamespace

import numpy as np

FAULTS = ("unchanged", "half", "dropped", "altered")


@functools.lru_cache(maxsize=4)
def _verifier(ref_name: str, vk: bytes, seed: int):
    """The reference's verdict function, made once a worker process."""
    return importlib.import_module(f"{__package__}.reference.{ref_name}").verifier(vk, seed)


def _verify_one(job):
    ref_name, vk, seed, canonical, proof, inputs = job
    return _verifier(ref_name, vk, seed)(proof, inputs, canonical)


class Reference:
    """The reference's verdicts, memoised by (proof, inputs)."""

    def __init__(self, cfg: dict, vk: bytes, seed: int, canonical: bool = True):
        self.args = (cfg["protocol"], vk, seed, canonical)
        ref = importlib.import_module(f"{__package__}.reference.{cfg['protocol']}")
        self.verify = ref.verifier(vk, seed)
        self.canonical = canonical
        self.memo = {}

    def precompute(self, pool, workers: int) -> None:
        """Every pool item's verdict, in ``workers`` spawned processes (in
        this one where ``workers`` is 0)."""
        jobs = [(*self.args, p, list(i)) for p, i in zip(pool.proofs, pool.inputs)]
        if not workers:
            verdicts = [_verify_one(job) for job in jobs]
        else:
            with multiprocessing.get_context("spawn").Pool(workers) as procs:
                verdicts = procs.map(_verify_one, jobs, chunksize=8)
        for (_, _, _, _, p, i), v in zip(jobs, verdicts):
            self.memo[(p, tuple(i))] = v

    def __call__(self, proof: bytes, inputs) -> bool:
        key = (proof, tuple(inputs))
        if key not in self.memo:
            self.memo[key] = self.verify(proof, inputs, self.canonical)
        return self.memo[key]


class _Batch:
    def __init__(self, ref: Reference, fault):
        self.ref, self.fault, self.prev = ref, fault, None
        self.last_stats = SimpleNamespace(extra={"host_s": 0.0})

    def verify_batch_async(self, proofs, inputs):
        got = np.array([self.ref(p, i) for p, i in zip(proofs, inputs)])
        h = len(got) // 2
        if self.fault == "unchanged":
            got, self.prev = (np.ones_like(got) if self.prev is None else self.prev), got
        elif self.fault == "half":
            got[h:] = True
        elif self.fault == "dropped":
            got = got[:h]
        elif self.fault == "altered":
            got[0] = not got[0]
        return got


def _single(ref: Reference, fault):
    state = {"calls": 0, "prev": True}

    def verify(proof, inputs):
        n = state["calls"] = state["calls"] + 1
        got = ref(proof, inputs)
        if fault == "unchanged":
            got, state["prev"] = state["prev"], got
        elif fault == "half" and n % 2 == 0:
            got = True
        elif fault == "dropped" and n % 2 == 0:
            got = None
        elif fault == "altered" and n % 7 == 0:
            got = not got
        return got

    return verify


def stand_in(runner: str, ref: Reference, fault=None):
    """``ref`` shaped as ``runner``'s program, with ``fault`` planted."""
    return _Batch(ref, fault) if runner == "batch_async" else _single(ref, fault)


def factory(runner: str, seed: int, canonical: bool = True, fault=None, pool=None,
            workers: int = 0):
    """A ``system(cfg, vk)`` for ``run.run_cell``: the reference in the
    program's place (with ``pool``, every item's verdict computed
    beforehand, in ``workers`` processes)."""

    def system(cfg, vk):
        ref = Reference(cfg, vk, seed, canonical)
        if pool is not None:
            ref.precompute(pool, workers)
        return stand_in(runner, ref, fault)

    return system

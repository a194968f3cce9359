"""Timing, tracing and run statistics.

The port's copy of the JAX package's utils/profiling.py:

  * ``section(name)``: an accumulating wall-clock section timer, read with
    ``get_timings()`` and cleared with ``reset_timings()``;
  * ``trace(path)``: a ``torch.profiler`` trace of the block (CUDA
    activity too where a card is in use), exported as a Chrome trace to
    ``path`` (where the JAX package's is a jax.profiler trace);
  * ``RunStats``: the throughput record of a verification run.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import asdict, dataclass, field
from typing import Dict

_timings: Dict[str, float] = {}


@contextlib.contextmanager
def section(name: str):
    """Accumulating wall-clock timer; read with get_timings()."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _timings[name] = _timings.get(name, 0.0) + time.perf_counter() - t0


def get_timings() -> Dict[str, float]:
    return dict(_timings)


def reset_timings() -> None:
    _timings.clear()


@contextlib.contextmanager
def trace(path: str):
    """Profile the block with torch.profiler (CPU, and CUDA where a card
    is available) and write a Chrome trace (chrome://tracing, Perfetto) to
    ``path``. Yields the profiler, whose ``key_averages()`` tabulate it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))


@dataclass
class RunStats:
    """Structured throughput record for a verification run."""

    protocol: str
    batch_size: int
    n_chips: int
    elapsed_s: float
    n_valid: int
    mesh_shape: tuple = ()
    pairings_per_proof: int = 3
    extra: dict = field(default_factory=dict)

    @property
    def proofs_per_sec(self) -> float:
        return self.batch_size / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def proofs_per_sec_per_chip(self) -> float:
        return self.proofs_per_sec / max(1, self.n_chips)

    @property
    def pairings_per_sec(self) -> float:
        return self.proofs_per_sec * self.pairings_per_proof

    def to_json(self) -> str:
        d = asdict(self)
        d["proofs_per_sec"] = round(self.proofs_per_sec, 2)
        d["proofs_per_sec_per_chip"] = round(self.proofs_per_sec_per_chip, 2)
        d["pairings_per_sec"] = round(self.pairings_per_sec, 2)
        return json.dumps(d)

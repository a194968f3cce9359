"""Timing, tracing and run statistics.

The port's copy of the JAX package's utils/profiling.py:

  * ``section(name)``: an accumulating wall-clock section timer, always
    on, read with ``get_timings()`` and cleared with ``reset_timings()``;
  * ``trace(path)``: a ``torch.profiler`` trace of the block (CUDA
    activity too where a card is in use), exported as a Chrome trace to
    ``path`` (where the JAX package's is a jax.profiler trace);
  * ``RunStats``: the throughput record of a verification run;

and the port's own spans and counters, which the program records where
its work happens (``bn254.<layer>.<stage>``):

  * ``span(name)``: a context that records only while a ``torch.profiler``
    session records in the process (``trace(path)`` or any other). Then it
    opens a profiler range of that name on the profiler's host timeline,
    the clock the card's activity is aligned to, and adds its count, total
    seconds, self seconds (less its child spans) and parent span's name to
    a table. Otherwise it is one shared no-op context, for the cost of one
    flag check;
  * ``count(name, n=1)``: a counter in the same table, under the same gate;
  * ``snapshot()`` reads the table, ``reset()`` clears it. A table holds
    one traced stretch: the first span or count recorded after one that
    found no profiler clears it first, so after a traced block it holds
    that block alone.

The range is a ``_RecordFunctionFast``, not a ``record_function``: the
latter costs microseconds even with no profiler on, and, being a user
annotation, is copied by the profiler onto the card's timeline as if it
were device work.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Dict

import torch

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


_recording = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast
_spans: Dict[str, list] = {}  # name -> [count, total ns, self ns, parent's name]
_counters: Dict[str, int] = {}
_lock = threading.Lock()
_open = threading.local()  # .stack: this thread's open spans, innermost last
_lapsed = False  # a span or count found no profiler since the last record


_OFF = contextlib.nullcontext()  # the shared context of a span that records nothing


def _new_stretch() -> None:
    """The first record after one that found no profiler: clear the table."""
    global _lapsed
    _lapsed = False
    reset()


class _Span:
    __slots__ = ("name", "range", "parent", "child_ns", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.child_ns = 0
        self.range = _Range(self.name, ())  # a tuple: None aborts the process
        self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        self.range.__exit__(*exc)
        stack = _open.stack
        if stack and stack[-1] is self:
            stack.pop()
        parent = self.parent
        if parent is not None:
            parent.child_ns += dt
        with _lock:
            row = _spans.get(self.name)
            if row is None:
                row = _spans[self.name] = [0, 0, 0, None]
            row[0] += 1
            row[1] += dt
            row[2] += dt - self.child_ns
            row[3] = parent.name if parent is not None else None
        return False


def span(name: str):
    """A context recording the block as span ``name`` while a profiler
    records (see the module's docstring); else a shared no-op."""
    global _lapsed
    if not _recording():
        _lapsed = True
        return _OFF
    if _lapsed:
        _new_stretch()
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    global _lapsed
    if not _recording():
        _lapsed = True
        return
    if _lapsed:
        _new_stretch()
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def snapshot() -> dict:
    """The table: ``{"spans": {name: {"count", "total_s", "self_s",
    "parent"}}, "counters": {name: n}}``; ``parent`` is the enclosing
    span's name at the span's latest record (None at the top)."""
    with _lock:
        return {"spans": {name: {"count": c, "total_s": t / 1e9, "self_s": own / 1e9,
                                 "parent": parent}
                          for name, (c, t, own, parent) in _spans.items()},
                "counters": dict(_counters)}


def reset() -> None:
    """Clear the spans' and counters' table."""
    with _lock:
        _spans.clear()
        _counters.clear()


@contextlib.contextmanager
def trace(path: str):
    """Profile the block with torch.profiler (CPU, and CUDA where a card
    is available) and write a Chrome trace (chrome://tracing, Perfetto) to
    ``path``. Yields the profiler, whose ``key_averages()`` tabulate it."""
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

"""What a ``--trace 1`` run reads from ``torch.profiler``.

The device's own events (kernels, copies, sets) as [start, end) intervals
in microseconds, their union (the time at least one ran, whatever the
streams overlap: the arithmetic of the port's pipeline_probe.py), the
benchmark's own spans (``vb.*``, recorded with ``record_function``
around each call into the program), the kernels' time by name and the
idle gaps named by what the host was doing. Nothing here imports the
program.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

WINDOW_SPAN = "vb.window"


def merged(intervals) -> list:
    """The union as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clipped_union_us(busy: list, starts: list, lo: float, hi: float) -> float:
    """The part of the disjoint sorted intervals ``busy`` (``starts`` their
    starts) inside [lo, hi)."""
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    total = 0.0
    while i < len(busy) and busy[i][0] < hi:
        total += max(0.0, min(hi, busy[i][1]) - max(lo, busy[i][0]))
        i += 1
    return total


class Tracer:
    """Spans around the benchmark's calls into the program, recorded only
    while tracing (a no-op context otherwise)."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self):
        """Profile the window (CPU and CUDA activity) when tracing."""
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with self.span(WINDOW_SPAN):
                yield
        self.prof = prof


def read(prof) -> dict:
    """The trace's device intervals and the benchmark's spans, reduced:
    ``window`` (the traced window), ``busy`` (the union of every device
    event, disjoint), ``kernel_busy`` (of kernels alone), ``spans``
    ({name: [(start, end)]} of the ``vb.*`` spans on the host), ``ops_by_name``
    ({device operation: us}) and ``cpu`` (the host's events, for naming
    gaps). The profiler also copies each ``record_function`` span onto the
    device's timeline; those copies are no device work and are dropped."""
    from torch.autograd import DeviceType

    dev_all, dev_kernels, spans, cpu = [], [], defaultdict(list), []
    by_name = defaultdict(float)
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("vb."):  # a span's copy on the device's timeline
                continue
            dev_all.append((start, end))
            by_name[e.name] += end - start
            if not e.name.startswith(("Memcpy", "Memset")):
                dev_kernels.append((start, end))
        elif e.name.startswith("vb."):
            spans[e.name].append((start, end))
        else:
            cpu.append((start, end, e.name))
    (w0, w1), = spans[WINDOW_SPAN]
    return {"window": (w0, w1), "busy": merged(dev_all),
            "kernel_busy": merged(dev_kernels), "spans": dict(spans),
            "ops_by_name": dict(by_name), "cpu": sorted(cpu)}


def breakdown(t: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps in the
    window summed by what the host was doing at their midpoint (the
    innermost host event there, a ``vb.*`` span included), in seconds."""
    ops = sorted(t["ops_by_name"].items(), key=lambda kv: -kv[1])[:top]
    w0, w1 = t["window"]
    edges = [w0] + [x for b in t["busy"] for x in b] + [w1]
    host = t["cpu"] + [(s, e, name) for name, ss in t["spans"].items()
                       if name != WINDOW_SPAN for s, e in ss]
    host.sort()
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    for lo, hi in zip(edges[0::2], edges[1::2]):
        lo, hi = max(lo, w0), min(hi, w1)
        if hi <= lo:
            continue
        mid = (lo + hi) / 2
        name = "host: no traced call"
        for s, e, n in reversed(host[max(0, bisect.bisect_right(starts, mid) - 400):
                                     bisect.bisect_right(starts, mid)]):
            if e >= mid:
                name = n
                break
        gaps[name] += hi - lo
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[n, us / 1e6] for n, us in idle]}


def reduce(t: dict) -> dict:
    """The numbers the per-layer readers take: the traced window, the time
    in it in which any device operation ran (``busy_us``) and in which a
    kernel ran (``kernel_us``), and for every ``vb.call`` span (busy us,
    kernel us, duration us) inside it."""
    w0, w1 = t["window"]
    busy, kern = t["busy"], t["kernel_busy"]
    bs, ks = [b[0] for b in busy], [k[0] for k in kern]
    calls = [(clipped_union_us(busy, bs, s, e), clipped_union_us(kern, ks, s, e), e - s)
             for s, e in t["spans"].get("vb.call", [])]
    return {"window_us": w1 - w0, "busy_us": clipped_union_us(busy, bs, w0, w1),
            "kernel_us": clipped_union_us(kern, ks, w0, w1), "calls": calls}

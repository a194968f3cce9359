"""Where a pipelined batch loop spends its time on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 -m snark_bn254_verifier_tpu_torch.pipeline_probe

It prints the card's name and power limit, then, for the Groth16 batch
verifier at batch 1024 (fixtures/groth16_lanes.py) and the PlonK one
(fixtures/plonk_lanes.py, a bad lane of every kind every 37 lanes), a
synchronous batch's ``stage_ms`` and three rounds of ms a batch, in turns:
16 batches through ``verify_batch_async`` with at most two in flight on
the verifier's two streams (and where the host spends that time: in the
dispatch, its host stages, a wait for a free stream, a wait for the
bools), the same with both slots of its ring on one stream, and
``verify_batch`` one batch at a time; what one read of a ready bool
tensor costs with two batches in flight and with the card idle; then
the device time by
kernel that ``torch.profiler`` records over 8 pipelined batches beside
their wall clock, and the union of the kernels' intervals in the trace:
the time at least one kernel ran, whatever the streams overlap, and so
the card's idle share of the wall clock. Every batch's bools are checked.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from .fixtures.groth16_lanes import groth16_batch_lanes
from .fixtures.plonk_lanes import KINDS, plonk_batch_lanes
from .parallel.batch import Groth16BatchVerifier, PlonkBatchVerifier

BATCH = 1024


def pipelined_ms(ver, proofs, inputs, expected, batches: int) -> float:
    """ms a batch of ``batches`` verify_batch_async calls, two in flight."""
    return pipelined_split(ver, proofs, inputs, expected, batches)["ms"]


def pipelined_split(ver, proofs, inputs, expected, batches: int) -> dict:
    """The pipelined loop's ms a batch ("ms") and where the host spends
    them, ms a batch: inside verify_batch_async ("dispatch"), of which
    its host stages ("host_stages": the parse and pack laps of
    ``last_stats``) and the wait for a free slot of the ring
    ("slot_wait"), the rest being uploads and launches; and waiting for
    the bools ("bools_wait": of the batch two back, and at the end the
    last two, which are still running); and, per read, the mean ms of the
    reads whose batch had ended on the card when the read began
    ("ended_read": its end event complete, or no event to wait for) and
    the share of reads whose batch had not ("unended")."""
    ring, real_take = ver._ring, ver._ring.take
    split = dict.fromkeys(("dispatch", "host_stages", "slot_wait", "bools_wait"), 0.0)
    ended = []  # the ms of each read whose batch had ended

    def timed_take():
        t = time.perf_counter()
        slot = real_take()
        split["slot_wait"] += time.perf_counter() - t
        return slot

    def done(ok):
        end = getattr(ok, "_end", None)
        had_ended = end is None or end.query()
        t = time.perf_counter()
        assert ok.cpu().tolist() == expected
        wait = time.perf_counter() - t
        split["bools_wait"] += wait
        if had_ended:
            ended.append(wait)

    ring.take = timed_take
    try:
        torch.cuda.synchronize()
        pending = []
        t0 = time.perf_counter()
        for _ in range(batches):
            t = time.perf_counter()
            pending.append(ver.verify_batch_async(proofs, inputs))
            split["dispatch"] += time.perf_counter() - t
            split["host_stages"] += sum(ver.last_stats.extra["stage_ms"].values()) / 1e3
            if len(pending) > 2:
                done(pending.pop(0))
        for ok in pending:
            done(ok)
        wall = time.perf_counter() - t0
    finally:
        del ring.take
    return {"ms": wall / batches * 1e3, **{k: v / batches * 1e3 for k, v in split.items()},
            "ended_read": sum(ended) / len(ended) * 1e3 if ended else 0.0,
            "unended": 1 - len(ended) / batches}


def copy_ms_under_load(ver, proofs, inputs, expected, reads: int = 5) -> dict:
    """What a read costs apart from any wait: with two batches in flight
    on the verifier's streams, ms to ``.cpu()`` a (B,) bool tensor of the
    caller's stream that is already complete ("busy"), the same with the
    card idle ("idle"), each the mean of ``reads``. In the pipelined loop
    batch n-2 has ended before it is read (the ring's take waited for it),
    so its bools_wait is such a copy."""
    ready = torch.zeros(len(expected), dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()

    def reads_ms():
        t = time.perf_counter()
        for _ in range(reads):
            ready.cpu()
        return (time.perf_counter() - t) / reads * 1e3

    idle = reads_ms()
    pending = [ver.verify_batch_async(proofs, inputs) for _ in range(2)]
    busy = reads_ms()
    for ok in pending:
        assert ok.cpu().tolist() == expected
    return {"busy": busy, "idle": idle}


def sync_ms(ver, proofs, inputs, expected, batches: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batches):
        assert ver.verify_batch(proofs, inputs).tolist() == expected
    return (time.perf_counter() - t0) / batches * 1e3


def busy_ms(intervals) -> float:
    """The union of [start, end) intervals in us, as ms: the time at least
    one of them runs."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def device_intervals(prof) -> dict:
    """[start, end) in us of the device's own events in a torch.profiler
    trace: "kernels", and "all" with the copies and sets."""
    from torch.autograd import DeviceType

    out = {"kernels": [], "all": []}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        out["all"].append(span)
        if not e.name.startswith(("Memcpy", "Memset")):
            out["kernels"].append(span)
    return out


def probe(name: str, make, proofs, inputs, expected) -> None:
    """Three rounds of ms a batch, in turns: 16 pipelined batches on the
    verifier's two streams, the same with both slots on one stream, 8
    synchronous ones; then the device time by kernel over 8 pipelined
    batches beside their wall clock."""
    from torch.profiler import ProfilerActivity, profile

    two, one = make(), make()
    for ver in (two, one):
        for _ in range(3):  # builds the kernels once, then both slots of each ring
            ver.verify_batch(proofs, inputs)
    one._ring.slots[1].stream = one._ring.slots[0].stream
    print(f"{name} sync stage ms: " + json.dumps(
        {k: round(v, 3) for k, v in two.last_stats.extra["stage_ms"].items()}))
    for rnd in range(3):
        split = pipelined_split(two, proofs, inputs, expected, 16)
        print(f"{name} round {rnd}, two streams, the host's ms a batch: " + ", ".join(
            f"{k} {v:.3f}" for k, v in split.items()))
        row = {"two streams": split["ms"],
               "one stream": pipelined_ms(one, proofs, inputs, expected, 16),
               "verify_batch": sync_ms(two, proofs, inputs, expected, 8)}
        print(f"{name} round {rnd}, ms a batch: "
              + ", ".join(f"{k} {v:.3f}" for k, v in row.items()))

    copy = copy_ms_under_load(two, proofs, inputs, expected)
    print(f"{name} a ready (B,) bool tensor's .cpu(): {copy['busy']:.3f} ms with two batches "
          f"in flight, {copy['idle']:.3f} ms with the card idle")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = pipelined_ms(two, proofs, inputs, expected, 8) * 8
    rows = sorted(((e.key, e.device_time_total) for e in prof.key_averages()),
                  key=lambda r: -r[1])
    # the device's own entries (kernels, copies), not the host ops that
    # launched them (aten::*, cuda* API calls), whose device time repeats it
    summed = sum(us for key, us in rows if not key.startswith(("aten::", "cuda"))) / 1e3
    spans = device_intervals(prof)
    kernels, busy = busy_ms(spans["kernels"]), busy_ms(spans["all"])
    print(f"{name} profiled 8 pipelined batches: wall {wall:.3f} ms; kernels running "
          f"{kernels:.3f} ms ({len(spans['kernels'])} kernels), any device event {busy:.3f} "
          f"ms, so the card idle {100 * (1 - busy / wall):.1f}% of the wall clock; device "
          f"time summed over events {summed:.3f} ms (streams overlap); device time by kernel:")
    for key, us in rows[:10]:
        print(f"  {key[:60]}: {us / 1e3:.3f} ms")


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    vec, proofs, inputs, expected = groth16_batch_lanes(BATCH)
    probe("Groth16", lambda: Groth16BatchVerifier(vec.vk, device="cuda"), proofs, inputs,
          expected)
    bad = {lane: KINDS[k % len(KINDS)] for k, lane in enumerate(range(3, BATCH, 37))}
    vec, proofs, inputs, expected = plonk_batch_lanes(BATCH, bad)
    probe("PlonK", lambda: PlonkBatchVerifier(vec.vk, device="cuda"), proofs, inputs, expected)


if __name__ == "__main__":
    main()

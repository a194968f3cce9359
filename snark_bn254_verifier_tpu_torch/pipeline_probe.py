"""Where a pipelined batch loop spends its time on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 -m snark_bn254_verifier_tpu_torch.pipeline_probe

It prints the card's name and power limit, then, for the Groth16 batch
verifier at batch 1024 (fixtures/groth16_lanes.py), three rounds of ms a
batch, in turns: ``verify_batch`` one batch at a time, 16 batches through
``verify_batch_async`` with at most two in flight on the verifier's two
streams, and the same with both slots of its ring on one stream; then the
device time by kernel that ``torch.profiler`` records over 8 pipelined
batches beside their wall clock; then the PlonK batch's ``stage_ms``
(chip_smoke.py's lanes) over 4 runs. Every batch's bools are checked.
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
    torch.cuda.synchronize()
    pending = []
    t0 = time.perf_counter()
    for _ in range(batches):
        pending.append(ver.verify_batch_async(proofs, inputs))
        if len(pending) > 2:
            assert pending.pop(0).cpu().tolist() == expected
    for ok in pending:
        assert ok.cpu().tolist() == expected
    return (time.perf_counter() - t0) / batches * 1e3


def sync_ms(ver, proofs, inputs, expected, batches: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batches):
        assert ver.verify_batch(proofs, inputs).tolist() == expected
    return (time.perf_counter() - t0) / batches * 1e3


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    vec, proofs, inputs, expected = groth16_batch_lanes(BATCH)
    two = Groth16BatchVerifier(vec.vk, device="cuda")
    one = Groth16BatchVerifier(vec.vk, device="cuda")
    for ver in (two, one):
        for _ in range(3):  # builds the kernels once, then both slots of each ring
            ver.verify_batch(proofs, inputs)
    one._ring.slots[1].stream = one._ring.slots[0].stream
    print("Groth16 sync stage ms: " + json.dumps(
        {k: round(v, 3) for k, v in two.last_stats.extra["stage_ms"].items()}))
    for rnd in range(3):
        row = {"two streams": pipelined_ms(two, proofs, inputs, expected, 16),
               "one stream": pipelined_ms(one, proofs, inputs, expected, 16),
               "verify_batch": sync_ms(two, proofs, inputs, expected, 8)}
        print(f"round {rnd}, ms a batch: " + ", ".join(f"{k} {v:.3f}" for k, v in row.items()))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = pipelined_ms(two, proofs, inputs, expected, 8) * 8
    rows = sorted(((e.key, e.device_time_total) for e in prof.key_averages()),
                  key=lambda r: -r[1])
    print(f"profiled 8 pipelined batches: wall {wall:.3f} ms; device time by kernel:")
    for key, us in rows[:8]:
        print(f"  {key[:60]}: {us / 1e3:.3f} ms")

    bad = {lane: KINDS[k % len(KINDS)] for k, lane in enumerate(range(3, BATCH, 37))}
    vec, proofs, inputs, expected = plonk_batch_lanes(BATCH, bad)
    ver = PlonkBatchVerifier(vec.vk, device="cuda")
    for _ in range(4):
        assert ver.verify_batch(proofs, inputs).tolist() == expected
        print("PlonK stage ms: " + json.dumps(
            {k: round(v, 3) for k, v in ver.last_stats.extra["stage_ms"].items()}))


if __name__ == "__main__":
    main()

"""pipeline_probe.py's device accounting: the union of the kernels'
intervals in a torch.profiler trace, which gives the card's busy time
when two streams overlap (the sum of their device times counts the
overlap twice)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from snark_bn254_verifier_tpu_torch.pipeline_probe import busy_ms, device_intervals


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 1000)], 1.0),
    ([(0, 1000), (2000, 2500)], 1.5),  # a gap: idle between
    ([(0, 1000), (500, 1500)], 1.5),  # two streams overlap
    ([(500, 1500), (0, 1000), (200, 300)], 1.5),  # any order, one inside another
    ([(0, 1000), (1000, 2000)], 2.0),  # end to end
])
def test_busy_ms_is_the_union(intervals, want):
    assert busy_ms(intervals) == pytest.approx(want)


def test_device_intervals_of_a_cpu_trace_are_empty():
    """A trace with no device events gives no intervals (and no busy time),
    not the host ops' times."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64).sum()
    spans = device_intervals(prof)
    assert spans == {"kernels": [], "all": []} and busy_ms(spans["all"]) == 0.0


def test_pipelined_split_accounts_the_host(monkeypatch):
    """The probe's split of a pipelined loop on a stand-in verifier: every
    batch dispatched and checked, the ring's take timed and given back,
    the host stages summed from each call's last_stats, and the parts of
    the host's time no larger than the wall clock."""
    from types import SimpleNamespace

    from snark_bn254_verifier_tpu_torch import pipeline_probe as probe

    class Ring:
        def __init__(self):
            self.taken = 0

        def take(self):
            self.taken += 1

    class Ver:
        def __init__(self):
            self._ring = Ring()

        def verify_batch_async(self, proofs, inputs):
            self._ring.take()
            self.last_stats = SimpleNamespace(extra={"stage_ms": {"parse_ms": 1.0,
                                                                  "pack_ms": 2.0}})
            return torch.tensor([True, False])

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    ver = Ver()
    split = probe.pipelined_split(ver, None, None, [True, False], 5)
    assert ver._ring.taken == 5 and "take" not in vars(ver._ring)
    assert split["host_stages"] == pytest.approx(3.0)
    assert set(split) == {"ms", "dispatch", "host_stages", "slot_wait", "bools_wait",
                          "ended_read", "unended"}
    assert 0 <= split["slot_wait"] <= split["dispatch"]
    # a plain tensor has no end event to wait for: every read counts as ended
    assert split["unended"] == 0 and split["ended_read"] == pytest.approx(split["bools_wait"])
    assert split["dispatch"] + split["bools_wait"] <= split["ms"] + 1e-6

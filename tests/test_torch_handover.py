"""How verify_batch_async hands its bools over (parallel/batch.py::HandedOver):
dispatch queues no wait on the caller's stream; a batch's first use on a
stream queues one wait there, for that batch's own end event, and later
uses on that stream none; ops on the tensor return plain tensors. On the
CPU with stand-in events, streams and waiter; on a card (``gpu``) a read
of batch n-2 while batch n is in flight."""

import pytest
import torch

from snark_bn254_verifier_tpu_torch.parallel.batch import HandedOver, _Run


class Event:
    def __init__(self, k):
        self.k = k


class Slot:
    """A ring slot whose end events are stand-ins, numbered by batch."""

    def __init__(self):
        self.marked = 0

    def mark_end(self):
        self.marked += 1
        return Event(self.marked)


class Streams:
    """The stand-in current stream and a waiter that records each wait as
    (stream, batch of the event)."""

    def __init__(self):
        self.current = "caller"
        self.waits = []

    def lookup(self, device):
        assert device == torch.device("cpu")
        return self.current

    def wait(self, stream, end, ok):
        assert type(ok) is HandedOver
        self.waits.append((stream, end.k))


def dispatch(streams, n=3):
    """n batches handed over through _Run, as verify_batch_async does on
    CUDA; their bools alternate so that each batch is told apart."""
    slot = Slot()
    runs = [_Run(torch.tensor([k % 2 == 0, True, False]), None, slot) for k in range(n)]
    return [run.handed_over(streams.lookup, streams.wait) for run in runs]


def test_dispatch_queues_no_wait():
    streams = Streams()
    out = dispatch(streams)
    assert streams.waits == []
    assert all(isinstance(t, torch.Tensor) and type(t) is HandedOver for t in out)
    # reading metadata needs none of the values
    assert [t.shape for t in out] == [torch.Size([3])] * 3
    assert all(t.dtype == torch.bool and t.device.type == "cpu" and len(t) == 3 for t in out)
    assert streams.waits == []


def test_first_use_waits_for_its_own_batch_once():
    streams = Streams()
    first, second, third = dispatch(streams)
    assert first.cpu().tolist() == [True, True, False]
    assert streams.waits == [("caller", 1)]
    # later uses on the same stream queue no wait: tolist, numpy, indexing, ==, an op
    assert first.tolist() == [True, True, False]
    assert first.numpy().tolist() == [True, True, False]
    assert bool(first[0]) and (first == torch.tensor([True, True, False])).all()
    assert torch.cat([first, first]).sum().item() == 4
    assert streams.waits == [("caller", 1)]
    # batch 3 read next waits for batch 3 alone; batch 2 never waited for
    assert third.tolist() == [True, True, False]
    assert streams.waits == [("caller", 1), ("caller", 3)]
    assert second.tolist() == [False, True, False]
    assert streams.waits == [("caller", 1), ("caller", 3), ("caller", 2)]


def test_use_on_another_stream_waits_there_once():
    streams = Streams()
    first = dispatch(streams, 1)[0]
    first.sum()
    streams.current = "side"
    first.sum()
    first.any()
    assert streams.waits == [("caller", 1), ("side", 1)]


def test_an_argument_among_others_waits_too():
    """The tensor given as a later argument or inside a list still waits."""
    streams = Streams()
    a, b = dispatch(streams, 2)
    plain = torch.ones(3, dtype=torch.bool)
    assert torch.logical_and(plain, b).tolist() == [False, True, False]
    assert streams.waits == [("caller", 2)]
    assert torch.stack([plain, a]).shape == (2, 3)
    assert streams.waits == [("caller", 2), ("caller", 1)]


@pytest.mark.parametrize("op", [
    lambda t: t.cpu(), lambda t: t[1:], lambda t: t == True, lambda t: ~t,  # noqa: E712
    lambda t: t.to(torch.int32), lambda t: t.clone(), lambda t: torch.where(t, 1, 0),
    lambda t: t.view(3), lambda t: t.detach(),
])
def test_ops_return_plain_tensors(op):
    streams = Streams()
    t = dispatch(streams, 1)[0]
    out = op(t)
    assert type(out) is torch.Tensor
    assert streams.waits == [("caller", 1)]
    assert "HandedOver" not in repr(t) and repr(t).startswith("tensor(")


def test_cpu_runs_hand_over_the_plain_tensor():
    """No ring slot (the CPU): the bools as they are, no subclass."""
    ok = torch.tensor([True, False])
    assert _Run(ok, None).handed_over() is ok


@pytest.mark.gpu
def test_read_of_batch_n_minus_2_while_n_in_flight_on_cuda():
    """On the card: three Groth16 batches dispatched, two in flight, the
    first read while the third runs: every batch's bools exact, each a
    HandedOver whose ops give plain tensors; no stream waited for a batch
    before its first use, and reading the first waited on the caller's
    stream for the first alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from snark_bn254_verifier_tpu_torch import Groth16BatchVerifier
    from snark_bn254_verifier_tpu_torch.fixtures.groth16_lanes import groth16_batch_lanes

    vec, proofs, inputs, expected = groth16_batch_lanes(32)
    ver = Groth16BatchVerifier(vec.vk, device="cuda")
    ver.verify_batch(proofs, inputs)  # the kernels and the VK's tensors
    ver.verify_batch(proofs, inputs)  # the ring's second slot
    pending = [ver.verify_batch_async(proofs, inputs) for _ in range(3)]
    assert all(type(ok) is HandedOver and ok._waited == [] for ok in pending)
    first = pending.pop(0)
    host = first.cpu()
    assert type(host) is torch.Tensor and host.tolist() == expected
    assert first._waited == [torch.cuda.current_stream()]
    assert all(ok._waited == [] for ok in pending)
    for ok in pending:
        assert ok.tolist() == expected

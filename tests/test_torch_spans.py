"""The port's spans and counters (utils/profiling.py ``span``, ``count``,
``snapshot``, ``reset``), on the CPU under a CPU-only torch.profiler: off,
they record nothing and open no profiler range; on, the table's counts,
totals, self times and parents, the range as a host event that is no user
annotation, and one traced stretch a table. Also the ring's wait as a span,
and the benchmark's readers of the table (verify_bench/metrics/)."""

import importlib.util
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from snark_bn254_verifier_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent


def traced():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def no_range(*args):
        raise AssertionError("a profiler range was opened with no profiler on")

    monkeypatch.setattr(profiling, "_Range", no_range)
    assert not torch._C._autograd._profiler_enabled()
    profiling.reset()
    with profiling.span("bn254.t.outer"):
        with profiling.span("bn254.t.inner"):
            profiling.count("bn254.t.n", 5)
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    assert profiling.span("bn254.t.a") is profiling.span("bn254.t.b")  # one shared no-op


def test_on_counts_totals_self_times_and_parents():
    profiling.reset()
    with traced() as prof:
        with profiling.span("bn254.t.outer"):
            time.sleep(0.01)
            for _ in range(2):
                with profiling.span("bn254.t.inner"):
                    time.sleep(0.01)
            profiling.count("bn254.t.n", 3)
        profiling.count("bn254.t.n")
    snap = profiling.snapshot()
    outer, inner = snap["spans"]["bn254.t.outer"], snap["spans"]["bn254.t.inner"]
    assert set(snap["spans"]) == {"bn254.t.outer", "bn254.t.inner"}
    assert (outer["count"], outer["parent"]) == (1, None)
    assert (inner["count"], inner["parent"]) == (2, "bn254.t.outer")
    assert inner["total_s"] >= 0.02 and inner["self_s"] == inner["total_s"]
    assert outer["total_s"] >= 0.03
    assert outer["self_s"] == pytest.approx(outer["total_s"] - inner["total_s"], abs=1e-9)
    assert 0.01 <= outer["self_s"] < outer["total_s"]
    assert snap["counters"] == {"bn254.t.n": 4}

    ranges = [e for e in prof.events() if e.name.startswith("bn254.t.")]
    assert sorted(e.name for e in ranges) == ["bn254.t.inner", "bn254.t.inner",
                                              "bn254.t.outer"]
    from torch.autograd import DeviceType

    for e in ranges:  # on the host's timeline, not copied to a device's
        assert e.device_type == DeviceType.CPU and not e.is_user_annotation
    (o,) = [e for e in ranges if e.name == "bn254.t.outer"]
    for e in ranges:
        assert o.time_range.start <= e.time_range.start <= e.time_range.end <= o.time_range.end


def test_a_span_that_raises_is_recorded_and_closed():
    profiling.reset()
    with traced():
        with pytest.raises(ValueError):
            with profiling.span("bn254.t.outer"):
                with profiling.span("bn254.t.boom"):
                    raise ValueError
        with profiling.span("bn254.t.after"):
            pass
    spans = profiling.snapshot()["spans"]
    assert spans["bn254.t.boom"]["parent"] == "bn254.t.outer"
    assert spans["bn254.t.after"]["parent"] is None  # nothing left open


def test_a_table_holds_one_traced_stretch():
    """The first record after an untraced span clears the table; an
    untraced span alone leaves it as it is; reset() clears it."""
    profiling.reset()
    with traced():
        with profiling.span("bn254.t.first"):
            profiling.count("bn254.t.c")
    with profiling.span("bn254.t.untraced"):
        profiling.count("bn254.t.c")
    snap = profiling.snapshot()
    assert set(snap["spans"]) == {"bn254.t.first"} and snap["counters"] == {"bn254.t.c": 1}
    with traced():
        with profiling.span("bn254.t.second"):
            pass
    assert set(profiling.snapshot()["spans"]) == {"bn254.t.second"}
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_the_section_timer_is_untouched_by_spans():
    profiling.reset_timings()
    with traced():
        with profiling.section("s"), profiling.span("bn254.t.s"):
            pass
    assert set(profiling.get_timings()) == {"s"}
    profiling.reset_timings()


def test_the_rings_wait_for_a_free_stream_is_a_span():
    """_Ring.take waits (bn254.ring.wait) only for a slot whose last batch
    has an end event: stand-in slots, so no CUDA stream is made."""
    from snark_bn254_verifier_tpu_torch.parallel.batch import IN_FLIGHT, _Ring

    class End:
        waited = 0

        def synchronize(self):
            End.waited += 1

    class Slot:
        end = None

    ring = _Ring(torch.device("cpu"))
    ring.slots = [Slot() for _ in range(IN_FLIGHT)]
    ring.slots[0].end = End()
    profiling.reset()
    with traced():
        for _ in range(IN_FLIGHT):
            assert ring.take().end is None
        ring.slots[0].end = End()
        ring.take()
    assert End.waited == 2
    assert profiling.snapshot()["spans"]["bn254.ring.wait"]["count"] == 2


# --- the benchmark's readers of the table -------------------------------------

def reader(name: str):
    path = ROOT / "verify_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def row(count, total_s, parent=None):
    return {"count": count, "total_s": total_s, "self_s": total_s, "parent": parent}


BATCH = {"bn254.batch.dispatch": row(4, 0.1),
         "bn254.batch.parse": row(4, 0.03, "bn254.batch.dispatch"),
         "bn254.ring.wait": row(4, 0.05, "bn254.batch.dispatch"),
         "bn254.batch.upload": row(4, 0.002, "bn254.batch.dispatch"),
         "bn254.batch.launch": row(4, 0.006, "bn254.batch.dispatch")}
SINGLE = {"bn254.facade.verify": row(10, 0.12),
          "bn254.facade.parse": row(10, 0.001, "bn254.facade.verify"),
          "bn254.backend.msm": row(10, 0.04, "bn254.facade.verify"),
          "bn254.backend.pairing": row(10, 0.05, "bn254.facade.verify"),
          "bn254.backend.pack": row(20, 0.008, "bn254.backend.pairing"),
          "bn254.backend.read": row(20, 0.03, "bn254.backend.pairing")}
TABLE = {"spans": {**BATCH, **SINGLE},
         "counters": {"bn254.backend.reads": 19, "bn254.backend.uploads": 100}}

READS = [  # (metric, its value from TABLE, the span without which it reads nothing)
    ("slot_wait_ms.batch", 0.05 / 4 * 1e3, "bn254.batch.dispatch"),
    ("enqueue_ms.batch", 0.008 / 4 * 1e3, "bn254.batch.dispatch"),
    ("facade_ms.single", (0.12 - 0.04 - 0.05) / 10 * 1e3, "bn254.facade.verify"),
    ("backend_pack_ms.single", 0.008 / 10 * 1e3, "bn254.facade.verify"),
    ("readbacks.single", 1.9, "bn254.facade.verify"),
]


@pytest.mark.parametrize("name,want,outer", READS, ids=[r[0] for r in READS])
def test_reader_of_a_synthetic_table(name, want, outer):
    read = reader(name)
    assert read({"trace": {}}, TABLE) == pytest.approx(want)
    assert read({}, TABLE) is None  # an untraced run reports no per-layer metric
    without = {"spans": {k: v for k, v in TABLE["spans"].items() if k != outer},
               "counters": TABLE["counters"]}
    assert read({"trace": {}}, without) is None


@pytest.mark.parametrize("name", [r[0] for r in READS])
def test_reader_of_a_program_without_spans_reads_nothing(name, monkeypatch):
    """An empty table (no traced call), or a program that has no table at
    all: no number, and no exception."""
    read = reader(name)
    profiling.reset()
    assert read({"trace": {}}) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert read({"trace": {}}) is None

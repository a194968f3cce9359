"""Where the program records its spans and counters: both batch verifiers
and both facades on ``device="cpu"``, each call traced by a CPU-only
torch.profiler, give the span names of utils/profiling.py's layers, each
under its parent, and their counters; the benchmark's readers read the
table they leave.

The heavy kernels' plain twins (the MSMs and the fixed-base window
table, the Miller products, the final exponentiation, the single call's
pairings) are stood in by results of their shapes: the verdicts are not
under test here, and the profiler would otherwise record the twins'
millions of tensor ops. The wrappers around them stay, so the fixed-base
MSM's lanes and the Miller product's prepared lanes are counted where the
program counts them."""

import hashlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from snark_bn254_verifier_tpu_torch import (Groth16BatchVerifier, Groth16Verifier,
                                            PlonkBatchVerifier, PlonkVerifier)
from snark_bn254_verifier_tpu_torch.fixtures.gen import gen_groth16_vector, gen_plonk_vector
from snark_bn254_verifier_tpu_torch.fixtures.groth16_lanes import groth16_batch_lanes
from snark_bn254_verifier_tpu_torch.fixtures.plonk_lanes import plonk_batch_lanes
from snark_bn254_verifier_tpu_torch.models.packing import pack_g1
from snark_bn254_verifier_tpu_torch.ops import msm as M
from snark_bn254_verifier_tpu_torch.ops import pairing as PR
from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC
from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn
from snark_bn254_verifier_tpu_torch.utils import errors, profiling
from torch_host_build import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
BATCH_SPANS = {"bn254.batch.dispatch": None,
               "bn254.batch.parse": "bn254.batch.dispatch",
               "bn254.batch.pack": "bn254.batch.dispatch",
               "bn254.batch.upload": "bn254.batch.dispatch",
               "bn254.batch.launch": "bn254.batch.dispatch"}
FACADE_SPANS = {"bn254.facade.verify": None,
                "bn254.facade.parse": "bn254.facade.verify",
                "bn254.backend.msm": "bn254.facade.verify",
                "bn254.backend.pairing": "bn254.facade.verify",
                "bn254.backend.read": "bn254.backend.pairing",
                "bn254.backend.pack": "bn254.backend.pairing"}


@pytest.fixture
def light(monkeypatch):
    """The heavy twins stood in: every MSM gives the generator, every
    window table zeros, every Miller product and pairing an Fq12 of zeros
    (so no pairing is one). The stand-in msm_best records its calls in
    ``light``."""
    calls = []

    def gens(b):
        return tuple(torch.as_tensor(a) for a in pack_g1([bn.G1_GEN] * b))

    def msm_best(points, scalars, c=8):
        calls.append(points[0].shape[0])
        return gens(points[0].shape[-1])

    def table(points):
        return torch.zeros((points[0].shape[-1], M.FIXED_WINDOWS, M.FIXED_DIGITS,
                            M.ENTRY_WORDS), dtype=torch.int32)

    def fq12(b):
        return torch.zeros((16, 12, b), dtype=torch.int32)

    monkeypatch.setattr(M, "msm_best", msm_best)
    monkeypatch.setattr(M, "fixed_table_plain", table)
    monkeypatch.setattr(M, "msm_fixed_plain", lambda table, scalars: gens(scalars.shape[-1]))
    monkeypatch.setattr(PR, "miller_mixed", lambda p, q, fixed, *tables: fq12(
        fixed[0][0].shape[-1]))
    monkeypatch.setattr(PC, "final_exp", lambda f: f)
    monkeypatch.setattr(PC, "pairing_batch", lambda ps, qs: fq12(ps[0].shape[-1]))
    monkeypatch.setattr(PC, "pairing_batch_is_one",
                        lambda ps, qs: torch.zeros(ps[0].shape[-1], dtype=torch.bool))
    # e(alpha, beta) from the stand-ins must not reach another test's cache
    monkeypatch.setattr(Groth16Verifier, "_cache", {})
    return calls


def traced(call):
    """``call()`` with a profiler on, after one untraced call that warms
    the caches (and ends the table's stretch); the table and the result."""
    try:
        call()
    except errors.VerifierError:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        try:
            out = call()
        except errors.VerifierError as e:
            out = e
    return profiling.snapshot(), out


def parents(snap):
    return {name: s["parent"] for name, s in snap["spans"].items()}


def reader(name: str):
    path = ROOT / "verify_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("sync", [False, True], ids=["async", "sync"])
def test_groth16_batch_spans_and_counters(light, sync):
    """Native parse, lanes 3 (A corrupted) and 11 (one input short) masked
    on the host; lane 5 (B off the curve) is the card's to mask."""
    vec, proofs, inputs, _ = groth16_batch_lanes(12)
    ver = Groth16BatchVerifier(vec.vk, device="cpu")
    call = ver.verify_batch if sync else ver.verify_batch_async
    snap, ok = traced(lambda: call(proofs, inputs))
    assert len(ok) == 12 and ver.last_stats.extra["parser"] == "native"
    assert parents(snap) == BATCH_SPANS  # no ring on the CPU: no wait
    assert all(s["count"] == 1 for s in snap["spans"].values())
    assert snap["counters"] == {"bn254.batch.lanes": 12, "bn254.batch.host_rejects": 2,
                                "bn254.msm.fixed_lanes": 12,
                                "bn254.pairing.prepared_lanes": 12}
    d = snap["spans"]["bn254.batch.dispatch"]
    children = sum(snap["spans"][n]["total_s"] for n, parent in BATCH_SPANS.items() if parent)
    assert d["total_s"] == pytest.approx(d["self_s"] + children, rel=1e-6)
    # the parse span holds the parse lap; the pack lap also holds the
    # step from one span to the next
    stage_ms, spans = ver.last_stats.extra["stage_ms"], snap["spans"]
    assert spans["bn254.batch.parse"]["total_s"] * 1e3 >= stage_ms["parse_ms"]
    parse_pack = spans["bn254.batch.parse"]["total_s"] + spans["bn254.batch.pack"]["total_s"]
    assert parse_pack == pytest.approx(ver.last_stats.extra["host_s"], abs=1e-3)
    assert reader("enqueue_ms.batch")({"trace": {}}) > 0
    assert reader("slot_wait_ms.batch")({"trace": {}}) == 0.0


def test_a_ragged_groth16_batch_counts_one_python_parse(light):
    vec, proofs, inputs, _ = groth16_batch_lanes(4)
    proofs = [proofs[0], proofs[1][:100], *proofs[2:]]  # lane 1 truncated
    ver = Groth16BatchVerifier(vec.vk, device="cpu")
    snap, _ = traced(lambda: ver.verify_batch_async(proofs, inputs))
    assert ver.last_stats.extra["parser"] == "python"
    assert parents(snap) == BATCH_SPANS
    assert snap["counters"] == {"bn254.batch.lanes": 4, "bn254.batch.host_rejects": 2,
                                "bn254.batch.python_parse": 1,  # lanes 1 and 3
                                "bn254.msm.fixed_lanes": 4,
                                "bn254.pairing.prepared_lanes": 4}


def test_plonk_batch_spans_and_counters(light):
    vec, proofs, inputs, _ = plonk_batch_lanes(4, {1: "truncated", 2: "wrong_count"})
    ver = PlonkBatchVerifier(vec.vk, device="cpu")
    snap, ok = traced(lambda: ver.verify_batch_async(proofs, inputs, rng=lambda: 7))
    assert len(ok) == 4
    assert parents(snap) == BATCH_SPANS
    assert snap["counters"] == {"bn254.batch.lanes": 4, "bn254.batch.host_rejects": 2}


def test_a_plonk_batch_masked_on_the_host_is_parsed_only(light):
    vec, proofs, inputs, _ = plonk_batch_lanes(2, {0: "truncated", 1: "truncated"})
    ver = PlonkBatchVerifier(vec.vk, device="cpu")
    snap, ok = traced(lambda: ver.verify_batch_async(proofs, inputs))
    assert ok.tolist() == [False, False]
    assert parents(snap) == {"bn254.batch.dispatch": None,
                             "bn254.batch.parse": "bn254.batch.dispatch"}
    assert snap["counters"] == {"bn254.batch.lanes": 2, "bn254.batch.host_rejects": 2}


def test_groth16_facade_spans_and_counters(light):
    """One fixed-base MSM call (prepared input, over the prepared VK's
    window table) and one pairing product a call: two reads back, one
    upload for the MSM (its scalars) and six for the pairs."""
    vec = gen_groth16_vector(0)
    snap, ok = traced(lambda: Groth16Verifier.verify(vec.proof, vec.vk, vec.public_inputs,
                                                     device="cpu"))
    assert isinstance(ok, bool)
    assert parents(snap) == FACADE_SPANS
    assert {n: s["count"] for n, s in snap["spans"].items()} == {
        "bn254.facade.verify": 1, "bn254.facade.parse": 1, "bn254.backend.msm": 1,
        "bn254.backend.pairing": 1, "bn254.backend.pack": 2, "bn254.backend.read": 2}
    assert snap["counters"] == {"bn254.backend.uploads": 7, "bn254.backend.reads": 2,
                                "bn254.msm.fixed_lanes": 1}
    assert reader("readbacks.single")({"trace": {}}) == 2.0
    facade = reader("facade_ms.single")({"trace": {}})
    pack = reader("backend_pack_ms.single")({"trace": {}})
    assert 0 < facade and 0 < pack
    assert facade + pack <= snap["spans"]["bn254.facade.verify"]["total_s"] * 1e3


def test_groth16_facade_refused_at_parse_reads_nothing_back(light):
    vec = gen_groth16_vector(0)
    snap, out = traced(lambda: Groth16Verifier.verify(vec.proof[:100], vec.vk,
                                                      vec.public_inputs, device="cpu"))
    assert isinstance(out, errors.VerifierError)
    assert parents(snap) == {"bn254.facade.verify": None,
                             "bn254.facade.parse": "bn254.facade.verify"}
    assert snap["counters"] == {}
    assert reader("readbacks.single")({"trace": {}}) == 0.0


@pytest.mark.parametrize("path", ["groth16_batch", "groth16_single", "plonk_batch",
                                  "groth16_batch_past_the_limit",
                                  "groth16_single_past_the_limit"])
def test_fixed_lanes_count_the_lanes_that_took_msm_fixed(light, monkeypatch, tmp_path, path):
    """``bn254.msm.fixed_lanes`` under profiling.trace: a Groth16 batch
    counts its lanes, a valid single call 1; a PlonK batch counts none,
    and its three MSMs still go to msm_best (K2 on the card). Past
    FIXED_MAX_POINTS (here 1, so the vector's 3 k-points and the single
    call's 2 are past it) no table is built: the Groth16 MSM goes to
    msm_best once a call, and nothing is counted."""
    past = path.endswith("_past_the_limit")
    if past:
        monkeypatch.setattr(M, "FIXED_MAX_POINTS", 1)
    if path.startswith("groth16_batch"):
        vec, proofs, inputs, _ = groth16_batch_lanes(6)
        ver = Groth16BatchVerifier(vec.vk, device="cpu")
        call, want = (lambda: ver.verify_batch_async(proofs, inputs)), 6
    elif path.startswith("groth16_single"):
        vec = gen_groth16_vector(0)
        call, want = (lambda: Groth16Verifier.verify(vec.proof, vec.vk, vec.public_inputs,
                                                     device="cpu")), 1
    else:
        vec, proofs, inputs, _ = plonk_batch_lanes(4, {})
        ver = PlonkBatchVerifier(vec.vk, device="cpu")
        call, want = (lambda: ver.verify_batch_async(proofs, inputs, rng=lambda: 7)), None
    call()  # the VK's set-up, outside the trace
    light.clear()
    with profiling.trace(str(tmp_path / "trace.json")):
        call()
    assert profiling.snapshot()["counters"].get("bn254.msm.fixed_lanes") == (
        None if past else want)
    assert len(light) == {"plonk_batch": 3}.get(path, 1 if past else 0)


@pytest.mark.parametrize("path", ["groth16_batch", "groth16_single", "plonk_batch"])
def test_prepared_lanes_count_the_groth16_batch_lanes(light, tmp_path, path):
    """``bn254.pairing.prepared_lanes`` under profiling.trace: a Groth16
    batch counts every lane (its variable pair (A, B), whose lines
    g2_lines prepares for K3 on the card); the single call (K5) and a
    PlonK batch (K3 with no variable pair) count none."""
    if path == "groth16_batch":
        vec, proofs, inputs, _ = groth16_batch_lanes(6)
        ver = Groth16BatchVerifier(vec.vk, device="cpu")
        call, want = (lambda: ver.verify_batch_async(proofs, inputs)), 6
    elif path == "groth16_single":
        vec = gen_groth16_vector(0)
        call, want = (lambda: Groth16Verifier.verify(vec.proof, vec.vk, vec.public_inputs,
                                                     device="cpu")), None
    else:
        vec, proofs, inputs, _ = plonk_batch_lanes(4, {})
        ver = PlonkBatchVerifier(vec.vk, device="cpu")
        call, want = (lambda: ver.verify_batch_async(proofs, inputs, rng=lambda: 7)), None
    call()  # the VK's set-up, outside the trace
    with profiling.trace(str(tmp_path / "trace.json")):
        call()
    assert profiling.snapshot()["counters"].get("bn254.pairing.prepared_lanes") == want


def test_groth16_facade_keeps_the_vks_used_last(light, monkeypatch):
    """The facade's cache holds the CACHE_VKS VKs used last (here 2), each
    with its prepared key and window table: a VK used again is not
    prepared again, a third VK drops the one used longest ago, and a proof
    that fails to parse keeps its VK cached."""
    monkeypatch.setattr(Groth16Verifier, "CACHE_VKS", 2)
    vecs = [gen_groth16_vector(seed) for seed in range(3)]
    keys = [hashlib.sha256(v.vk).digest() for v in vecs]
    cache = Groth16Verifier._cache

    def verify(i, proof=None):
        v = vecs[i]
        try:
            Groth16Verifier.verify(v.proof if proof is None else proof, v.vk, v.public_inputs,
                                   device="cpu")
        except errors.VerifierError:
            pass

    verify(0)
    verify(1)
    first = cache[keys[0]]
    assert first[1].tables and list(cache) == keys[:2]
    verify(0, proof=vecs[0].proof[:100])  # refused at parse: the cache as it was
    assert list(cache) == keys[:2] and cache[keys[0]] is first
    verify(0)  # VK 0 now the newest
    assert list(cache) == [keys[1], keys[0]] and cache[keys[0]] is first
    verify(2)
    assert list(cache) == [keys[0], keys[2]] and cache[keys[0]] is first


def test_plonk_facade_spans(light):
    """verify_plonk's MSMs (the linearisation's, the KZG fold's) and its
    two-pair check; the stand-ins' check fails, so the call raises."""
    vec = gen_plonk_vector(0)
    snap, out = traced(lambda: PlonkVerifier.verify(vec.proof, vec.vk, vec.public_inputs,
                                                    device="cpu"))
    assert isinstance(out, errors.VerifierError)
    spans = snap["spans"]
    assert parents(snap) == {**FACADE_SPANS, "bn254.backend.pack": spans[
        "bn254.backend.pack"]["parent"], "bn254.backend.read": spans[
        "bn254.backend.read"]["parent"]}
    assert spans["bn254.backend.pairing"]["count"] == 1
    msms = spans["bn254.backend.msm"]["count"]
    assert msms >= 2
    assert spans["bn254.backend.pack"]["count"] == spans["bn254.backend.read"]["count"] \
        == msms + 1 == snap["counters"]["bn254.backend.reads"]
    assert np.isclose(spans["bn254.facade.verify"]["total_s"],
                      sum(s["self_s"] for s in spans.values()))

"""The port's copies of the JAX package's bench tooling, against the
originals: utils/profiling.py (``section``, ``get_timings``,
``reset_timings``, ``trace``, ``RunStats``), utils/config.py
(``VerifierConfig``), fixtures/extract_vk.py, the backend registry of
models/backend.py (``get_backend``, ``set_default_backend``), the
package's exports, and the whole pairings of ops/pairing.py (``pairing``,
``pairing_batch``, ``pairing_batch_is_one``) on the CPU against the
oracle. Slow: the JAX ``pairing_batch_is_one`` on the same pairs (an
XLA:CPU compile of minutes)."""

import dataclasses
import inspect
import json
import random
import time

import numpy as np
import pytest
import torch

import snark_bn254_verifier_tpu as jax_pkg
import snark_bn254_verifier_tpu_torch as port
from snark_bn254_verifier_tpu.fixtures import extract_vk as jax_extract
from snark_bn254_verifier_tpu.utils import config as jax_config
from snark_bn254_verifier_tpu.utils import profiling as jax_prof
from snark_bn254_verifier_tpu_torch.fixtures import extract_vk
from snark_bn254_verifier_tpu_torch.fixtures.gen import gen_groth16_vector, gen_plonk_vector
from snark_bn254_verifier_tpu_torch.models import backend as B
from snark_bn254_verifier_tpu_torch.models import torch_backend
from snark_bn254_verifier_tpu_torch.models.packing import pack_g1, pack_g2, pair_major, unpack_fq12
from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn
from snark_bn254_verifier_tpu_torch.ops import pairing as P
from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC
from snark_bn254_verifier_tpu_torch.utils import config, profiling
from torch_host_build import one_torch_thread  # noqa: F401 (autouse)


# --- utils/profiling.py ------------------------------------------------------


def test_section_accumulates_and_reset_clears():
    profiling.reset_timings()
    for _ in range(2):
        with profiling.section("a"):
            time.sleep(0.01)
    with profiling.section("b"):
        pass
    t = profiling.get_timings()
    assert set(t) == {"a", "b"} and t["a"] >= 0.02 and t["b"] >= 0.0
    t["a"] = -1.0  # a copy
    assert profiling.get_timings()["a"] >= 0.02
    profiling.reset_timings()
    assert profiling.get_timings() == {}


def test_section_times_a_block_that_raises():
    profiling.reset_timings()
    with pytest.raises(ValueError):
        with profiling.section("boom"):
            raise ValueError
    assert "boom" in profiling.get_timings()
    profiling.reset_timings()


RECORDS = [
    dict(protocol="groth16", batch_size=1024, n_chips=1, elapsed_s=0.017, n_valid=1019,
         pairings_per_proof=3, extra={"stage_ms": {"parse_ms": 2.5}}),
    dict(protocol="plonk", batch_size=32, n_chips=4, elapsed_s=0.0, n_valid=None,
         mesh_shape=(2, 2), pairings_per_proof=2),
]


@pytest.mark.parametrize("rec", RECORDS, ids=["groth16", "plonk_zero_elapsed"])
def test_run_stats_to_json_equals_jax(rec):
    mine, theirs = profiling.RunStats(**rec), jax_prof.RunStats(**rec)
    assert json.loads(mine.to_json()) == json.loads(theirs.to_json())
    assert (mine.proofs_per_sec, mine.proofs_per_sec_per_chip, mine.pairings_per_sec) == (
        theirs.proofs_per_sec, theirs.proofs_per_sec_per_chip, theirs.pairings_per_sec)


def test_run_stats_fields_equal_jax():
    assert [f.name for f in dataclasses.fields(profiling.RunStats)] == [
        f.name for f in dataclasses.fields(jax_prof.RunStats)]


def test_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    with profiling.trace(str(path)) as prof:
        torch.ones(64).sum()
    events = json.loads(path.read_text())["traceEvents"]
    assert events and prof.key_averages()


# --- utils/config.py ---------------------------------------------------------


def test_the_bench_run_is_a_verifier_config():
    """One configuration object: the bench's run extends VerifierConfig
    and reads its batch and window fields, at the JAX bench's values."""
    from snark_bn254_verifier_tpu_torch import bench

    run = bench.Run()
    assert isinstance(run, config.VerifierConfig)
    assert (run.batch_size, run.msm_window_bits) == (1024, 8)
    assert run.cache_dir == config.VerifierConfig().cache_dir


def test_verifier_config_equals_jax_but_cache_dir():
    mine, theirs = config.VerifierConfig(), jax_config.VerifierConfig()
    names = [f.name for f in dataclasses.fields(mine)]
    assert names == [f.name for f in dataclasses.fields(theirs)]
    for name in names:
        if name != "cache_dir":
            assert getattr(mine, name) == getattr(theirs, name), name
    from snark_bn254_verifier_tpu_torch.ops import _build

    assert config.VerifierConfig().cache_dir != theirs.cache_dir
    assert str(_build.BUILD_DIR.resolve()) == str(
        __import__("pathlib").Path(mine.cache_dir).resolve())
    assert not hasattr(config, "enable_compilation_cache")


# --- fixtures/extract_vk.py --------------------------------------------------


def _blob(with_vk: bool) -> bytes:
    rng = np.random.default_rng(8)
    head, tail = rng.bytes(3001), rng.bytes(1777)
    if not with_vk:
        return head + tail
    return head + extract_vk.DEFAULT_OUT.read_bytes() + tail


def test_extract_vk_finds_what_the_jax_module_finds(tmp_path, capsys):
    elf = tmp_path / "guest.elf"
    elf.write_bytes(_blob(True))
    got = extract_vk.extract(str(elf), tmp_path / "port.bin")
    out_port = capsys.readouterr().out
    want = jax_extract.extract(str(elf), tmp_path / "jax.bin")
    out_jax = capsys.readouterr().out
    assert got == want == extract_vk.DEFAULT_OUT.read_bytes()
    assert out_port == out_jax == f"found PlonK VK at offset 3001, {len(got)} bytes\n"
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    data = elf.read_bytes()
    assert list(extract_vk.find_vk_offsets(data)) == list(jax_extract.find_vk_offsets(data))
    assert extract_vk.vk_byte_length(data, 3001) == jax_extract.vk_byte_length(data, 3001)


def test_extract_vk_without_a_vk_exits_as_the_jax_module(tmp_path):
    elf = tmp_path / "empty.elf"
    elf.write_bytes(_blob(False))
    with pytest.raises(SystemExit) as mine:
        extract_vk.extract(str(elf), tmp_path / "port.bin")
    with pytest.raises(SystemExit) as theirs:
        jax_extract.extract(str(elf), tmp_path / "jax.bin")
    assert str(mine.value) == str(theirs.value) == "no valid PlonK VK found in ELF"
    assert not (tmp_path / "port.bin").exists()


def test_extract_vk_defaults():
    assert extract_vk.DEFAULT_ELF == jax_extract.DEFAULT_ELF
    assert extract_vk.DEFAULT_OUT.parent.name == "fixtures"
    assert extract_vk.DEFAULT_OUT.parent.parent.name == "snark_bn254_verifier_tpu_torch"


# --- the backend registry and the exports -------------------------------------


@pytest.fixture
def default_backend():
    """Restore the default backend after the test."""
    yield
    B.set_default_backend("torch")


def test_default_backend_routes_the_facades(default_backend, monkeypatch):
    """With the oracle as default, both facades called with neither device
    nor backend run on it: the torch backend is never made."""
    def no_torch(device):
        raise AssertionError("the torch backend was made")

    monkeypatch.setattr(torch_backend, "resolve_device", no_torch)
    monkeypatch.setattr(torch_backend.TorchBackend, "_instances", {})
    port.set_default_backend("oracle")
    assert port.get_backend() is port.get_backend("oracle") is B.get_backend(None)
    g = gen_groth16_vector(3)
    assert port.Groth16Verifier.verify(g.proof, g.vk, g.public_inputs) is True
    assert port.Groth16Verifier.verify(g.proof, g.vk, [g.public_inputs[0] + 1]
                                       + list(g.public_inputs[1:])) is False
    p = gen_plonk_vector(0)
    assert port.PlonkVerifier.verify(p.proof, p.vk, p.public_inputs) is True


def test_facade_device_names_the_torch_backend(default_backend):
    """A facade's one selector: ``device`` names the shared torch backend
    of that device, whatever the default; without it, the default."""
    port.set_default_backend("oracle")
    assert B.facade_backend("cpu") is torch_backend.TorchBackend.instance("cpu")
    assert B.facade_backend() is B.get_backend("oracle")
    for facade in (port.Groth16Verifier, port.PlonkVerifier):
        assert list(inspect.signature(facade.verify).parameters)[-1] == "device"


def test_torch_backend_by_name_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.get_backend("torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.get_backend()  # the default is torch on the card
    assert "cuda" not in torch_backend.TorchBackend._instances


def test_torch_backend_instances_and_objects():
    cpu = port.get_backend("torch:cpu")
    assert cpu is port.get_backend("torch:cpu") is torch_backend.TorchBackend.instance("cpu")
    assert cpu.device == torch.device("cpu")
    mine = port.TorchBackend("cpu")
    assert port.get_backend(mine) is mine and mine is not cpu
    with pytest.raises(ValueError):
        port.get_backend("jax")


def test_exports_cover_the_jax_package():
    assert set(jax_pkg.__all__) <= set(port.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None
    assert port.errors.PrepareInputsFailedError.__module__.startswith(
        "snark_bn254_verifier_tpu_torch")
    assert port.__version__ == jax_pkg.__version__


# --- whole pairings -----------------------------------------------------------


@pytest.fixture(scope="module")
def pairs():
    """Two lanes of two pairs: lane 0 random, lane 1 a pair and its
    negation (the product is one)."""
    rng = random.Random(9)
    p = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(3)]
    q = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(3)]
    ps = [[p[0], p[1]], [p[2], bn.g1_neg(p[1])]]  # pair-major: ps[j][lane]
    qs = [[q[0], q[1]], [q[2], q[1]]]
    return ps, qs


def _tensors(ps, qs):
    return (tuple(torch.as_tensor(a) for a in pair_major(pack_g1, ps)),
            tuple(torch.as_tensor(a) for a in pair_major(pack_g2, qs)))


def test_pairing_equals_oracle(pairs):
    ps, qs = pairs
    p1 = tuple(torch.as_tensor(a) for a in pack_g1(ps[0]))
    q1 = tuple(torch.as_tensor(a) for a in pack_g2(qs[0]))
    got = unpack_fq12(P.pairing(p1, q1).numpy())
    assert got == [bn.pairing(ps[0][lane], qs[0][lane]) for lane in range(2)]


def test_pairing_batch_and_is_one_equal_oracle(pairs, monkeypatch):
    """The plain whole pairings are the twins' alone: with every kernel
    wrapper of ops/pairing_cuda.py failing, they still equal the oracle."""
    for name in PC.KERNEL_ENTRY_POINTS:
        monkeypatch.setattr(PC, name, lambda *a, **k: pytest.fail("a kernel wrapper ran"))
    ps, qs = pairs
    P_, Q_ = _tensors(ps, qs)
    got = unpack_fq12(P.pairing_batch(P_, Q_).numpy())
    want = [bn.pairing_batch([(ps[j][lane], qs[j][lane]) for j in range(2)]) for lane in range(2)]
    assert got == want
    assert P.pairing_batch_is_one(P_, Q_).tolist() == [bn.fq12_is_one(w) for w in want] \
        == [False, True]


def test_kernel_pairings_on_cpu_tensors_are_the_twins(pairs):
    """ops/pairing_cuda.py's whole pairings (K5 then K4 on the card) send
    CPU tensors to the twins: the same limbs as ops/pairing.py's."""
    ps, qs = pairs
    P_, Q_ = _tensors(ps, qs)
    PC.reset_launch_counts()
    got = PC.pairing_batch(P_, Q_)
    assert torch.equal(got, P.pairing_batch(P_, Q_))
    assert PC.pairing_batch_is_one(P_, Q_).tolist() == [False, True]
    assert not any(PC.launch_counts().values())


@pytest.mark.slow  # the JAX pairing's XLA:CPU compile
def test_pairing_batch_is_one_equals_jax(pairs):
    from snark_bn254_verifier_tpu.models.jax_backend import pack_g1 as jpack_g1
    from snark_bn254_verifier_tpu.models.jax_backend import pack_g2 as jpack_g2
    from snark_bn254_verifier_tpu.ops import pairing as JP

    ps, qs = pairs

    def stack(cols):
        return tuple(np.stack([c[i] for c in cols]) for i in range(3))

    want = np.asarray(JP.pairing_batch_is_one(stack([jpack_g1(l) for l in ps]),
                                              stack([jpack_g2(l) for l in qs]))).tolist()
    assert P.pairing_batch_is_one(*_tensors(ps, qs)).tolist() == want == [False, True]

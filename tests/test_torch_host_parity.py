"""The port's copies of the JAX package's host modules agree with the
originals: the oracle, the fixtures (byte-equal vectors), serialization
(parsed values and error classes on good and corrupted bytes), the
transcript and hash-to-field, the error taxonomy, the protocol code on the
oracle backend (good and bad vectors), and the port's native parser
against its own Python parser. Everything runs on the oracle: no twin
pipeline, so the file stays cheap."""

import functools
import random

import numpy as np
import pytest

from snark_bn254_verifier_tpu.fixtures import gen as JG
from snark_bn254_verifier_tpu.models import groth16 as JG16
from snark_bn254_verifier_tpu.models import plonk as JPL
from snark_bn254_verifier_tpu.oracle import bn254 as jbn
from snark_bn254_verifier_tpu.utils import errors as JE
from snark_bn254_verifier_tpu.utils import hash_to_field as JH
from snark_bn254_verifier_tpu.utils import serialization as JS
from snark_bn254_verifier_tpu.utils import transcript as JT
from snark_bn254_verifier_tpu_torch.fixtures import gen as PG
from snark_bn254_verifier_tpu_torch.models import groth16 as PG16
from snark_bn254_verifier_tpu_torch.models import plonk as PPL
from snark_bn254_verifier_tpu_torch.oracle import bn254 as pbn
from snark_bn254_verifier_tpu_torch.ops.limbs import FQ, limbs_batch_to_ints
from snark_bn254_verifier_tpu_torch.utils import errors as PE
from snark_bn254_verifier_tpu_torch.utils import hash_to_field as PH
from snark_bn254_verifier_tpu_torch.utils import native
from snark_bn254_verifier_tpu_torch.utils import serialization as PS
from snark_bn254_verifier_tpu_torch.utils import transcript as PT

GENERATORS = {
    "groth16": ("gen_groth16_vector", (3,)),
    "groth16_sp1_shaped": ("gen_groth16_vector_sp1_shaped", (2,)),
    "plonk": ("gen_plonk_vector", (1,)),
}


@functools.lru_cache(maxsize=None)
def vector(kind, package):
    name, args = GENERATORS[kind]
    return getattr(JG if package == "jax" else PG, name)(*args)


def outcome(fn):
    """repr of the result, or the error's class name and message."""
    try:
        return ("ok", repr(fn()))
    except Exception as e:  # the error class itself is what is compared
        return ("raises", type(e).__name__, str(e))


def test_oracle_constants_and_pairing_equal():
    for name in ("P", "R", "X_PARAM", "ATE_LOOP_COUNT", "G1_GEN", "G2_GEN", "XI"):
        assert getattr(pbn, name) == getattr(jbn, name), name
    rng = random.Random(61)
    p = pbn.g1_mul(pbn.G1_GEN, rng.randrange(1, pbn.R))
    q = pbn.g2_mul(pbn.G2_GEN, rng.randrange(1, pbn.R))
    assert pbn.pairing(p, q) == jbn.pairing(p, q)


@pytest.mark.parametrize("kind", sorted(GENERATORS))
def test_fixture_vectors_byte_equal(kind):
    port, ref = vector(kind, "port"), vector(kind, "jax")
    assert port.proof == ref.proof
    assert port.vk == ref.vk
    assert list(port.public_inputs) == list(ref.public_inputs)


def test_committed_plonk_vk_byte_equal():
    from pathlib import Path

    import snark_bn254_verifier_tpu.fixtures as jf
    import snark_bn254_verifier_tpu_torch.fixtures as pf

    read = lambda mod: (Path(mod.__file__).parent / "plonk_vk.bin").read_bytes()  # noqa: E731
    assert read(pf) == read(jf)


def test_error_taxonomy_equal():
    ref = {n: c for n, c in vars(JE).items() if isinstance(c, type) and issubclass(c, Exception)}
    port = {n: c for n, c in vars(PE).items() if isinstance(c, type) and issubclass(c, Exception)}
    assert sorted(port) == sorted(ref)
    for name, cls in ref.items():
        assert [b.__name__ for b in port[name].__mro__] == [b.__name__ for b in cls.__mro__]


def corruptions(buf: bytes, seed: int, k: int = 6):
    """The bytes as they are, then k copies with one byte flipped, one cut
    short and one with a non-canonical coordinate (p at the front)."""
    rng = random.Random(seed)
    out = [buf]
    for _ in range(k):
        b = bytearray(buf)
        b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        out.append(bytes(b))
    out.append(buf[: len(buf) // 2])
    out.append(jbn.P.to_bytes(32, "big") + buf[32:])
    return out


@pytest.mark.parametrize("kind,what", [("groth16", "proof"), ("groth16", "vk"),
                                       ("plonk", "proof"), ("plonk", "vk")])
def test_serialization_parses_and_errors_equal(kind, what):
    proto = "groth16" if kind == "groth16" else "plonk"
    loader = f"load_{proto}_{'proof' if what == 'proof' else 'verifying_key'}_from_bytes"
    buf = getattr(vector(kind, "jax"), what)
    k = 2 if (proto, what) == ("plonk", "vk") else 6  # a PlonK VK parse takes G2 roots
    for i, b in enumerate(corruptions(buf, seed=62 + len(loader), k=k)):
        assert outcome(lambda: getattr(PS, loader)(b)) == outcome(lambda: getattr(JS, loader)(b)), i


def test_point_codecs_equal():
    rng = random.Random(63)
    for _ in range(4):
        p = pbn.g1_mul(pbn.G1_GEN, rng.randrange(1, pbn.R))
        q = pbn.g2_mul(pbn.G2_GEN, rng.randrange(1, pbn.R))
        for enc in ("g1_to_bytes", "g1_to_compressed_bytes", "g1_to_uncompressed_bytes"):
            assert getattr(PS, enc)(p) == getattr(JS, enc)(p)
        for enc in ("g2_to_compressed_bytes", "g2_to_uncompressed_bytes"):
            assert getattr(PS, enc)(q) == getattr(JS, enc)(q)
        c1, c2 = JS.g1_to_compressed_bytes(p), JS.g2_to_compressed_bytes(q)
        assert PS.compressed_to_g1(c1) == JS.compressed_to_g1(c1)
        assert PS.compressed_to_g2(c2) == JS.compressed_to_g2(c2)
    for buf in (b"\x00" * 64, b"\xff" * 64):
        assert outcome(lambda: PS.uncompressed_to_g1(buf)) == outcome(lambda: JS.uncompressed_to_g1(buf))


def test_transcript_and_hash_to_field_equal():
    rng = random.Random(64)
    names = [PT.GAMMA, PT.BETA, PT.ALPHA, PT.ZETA]
    assert names == [JT.GAMMA, JT.BETA, JT.ALPHA, JT.ZETA]
    port, ref = PT.Transcript(names), JT.Transcript(names)
    for name in names:
        for _ in range(3):
            data = rng.randbytes(rng.randrange(1, 80))
            port.bind(name, data)
            ref.bind(name, data)
        assert port.compute_challenge(name) == ref.compute_challenge(name)
    # challenge misuse raises the same error on both
    assert outcome(lambda: port.compute_challenge(PT.GAMMA)) == outcome(
        lambda: ref.compute_challenge(JT.GAMMA))
    for _ in range(4):
        msg, dst = rng.randbytes(rng.randrange(0, 100)), rng.randbytes(rng.randrange(1, 40))
        n = rng.randrange(1, 4)
        assert PH.expand_msg_xmd(msg, dst, 48 * n) == JH.expand_msg_xmd(msg, dst, 48 * n)
        assert PH.hash_to_field_bytes(msg, dst, n) == JH.hash_to_field_bytes(msg, dst, n)
        hp, hj = PH.WrappedHashToField(dst), JH.WrappedHashToField(dst)
        hp.write(msg)
        hj.write(msg)
        assert hp.sum() == hj.sum()


def corrupt_byte(proof: bytes) -> bytes:
    """The proof with one bit flipped inside its first G1 point (the case
    chip_smoke.py runs on the card)."""
    bad = bytearray(proof)
    bad[40] ^= 0x01
    return bytes(bad)


@pytest.mark.parametrize("case", ["good", "wrong input value", "wrong input count",
                                  "corrupted proof byte"])
def test_verify_groth16_on_oracle_equal(case):
    vec = vector("groth16", "port")
    ins = list(vec.public_inputs)
    ins = {"good": ins, "wrong input value": [ins[0] + 1] + ins[1:],
           "wrong input count": ins[:-1], "corrupted proof byte": ins}[case]
    proof_bytes = corrupt_byte(vec.proof) if case == "corrupted proof byte" else vec.proof

    def run(ser, mod):
        vk = ser.load_groth16_verifying_key_from_bytes(vec.vk)
        proof = ser.load_groth16_proof_from_bytes(proof_bytes)
        return mod.verify_groth16(vk, proof, ins, backend="oracle")

    got, want = outcome(lambda: run(PS, PG16)), outcome(lambda: run(JS, JG16))
    assert got == want
    assert want[:2] == {"good": ("ok", "True"), "wrong input value": ("ok", "False"),
                        "wrong input count": ("raises", "PrepareInputsFailedError"),
                        "corrupted proof byte": ("raises", "GroupError")}[case]


@pytest.mark.parametrize("case", ["good", "tampered claimed value", "wrong input count",
                                  "wrong input value", "corrupted proof byte",
                                  "opening proof doubled"])
def test_verify_plonk_on_oracle_equal(case):
    vec = vector("plonk", "port")
    ins = list(vec.public_inputs)
    proof = vec.proof
    if case == "wrong input count":
        ins = ins + [1]
    if case == "wrong input value":
        ins = [ins[0] + 1] + ins[1:]
    if case == "corrupted proof byte":
        proof = corrupt_byte(proof)
    if case == "opening proof doubled":
        # valid bytes that fail only in the final pairing check
        h = JS.load_plonk_proof_from_bytes(proof).batched_proof.h
        doubled = JS.g1_to_bytes(jbn.g1_mul(h, 2))
        assert proof.count(JS.g1_to_bytes(h)) == 1
        proof = proof.replace(JS.g1_to_bytes(h), doubled)
    if case == "tampered claimed value":
        # the first claimed value is checked before any pairing
        p = JS.load_plonk_proof_from_bytes(proof)
        v = JS.fr_to_bytes_be(p.batched_proof.claimed_values[0])
        assert proof.count(v) == 1
        proof = proof.replace(v, JS.fr_to_bytes_be((p.batched_proof.claimed_values[0] + 1) % jbn.R))

    def run(ser, mod):
        vk = ser.load_plonk_verifying_key_from_bytes(vec.vk)
        return mod.verify_plonk(vk, ser.load_plonk_proof_from_bytes(proof), ins,
                                backend="oracle", rng=lambda: 7)

    got, want = outcome(lambda: run(PS, PPL)), outcome(lambda: run(JS, JPL))
    assert got == want
    assert (want == ("ok", "True")) == (case == "good")
    if case in ("corrupted proof byte", "opening proof doubled"):
        assert want[:2] == ("raises", {"corrupted proof byte": "GroupError",
                                       "opening proof doubled": "PairingCheckFailedError"}[case])


@pytest.fixture(scope="module")
def native_lib():
    if not native.native_available():
        pytest.skip("no host C++ compiler for the native parser")
    return native


def test_native_parser_equals_python_parser(native_lib):
    """Lanes: the proof, copies with a bit flipped in A, B or C (the 256
    bytes the native parser reads; it leaves the commitments to the
    protocol code), and a non-canonical A.x."""
    vec = vector("groth16", "port")
    rng = random.Random(65)
    lanes = [vec.proof]
    for _ in range(10):
        b = bytearray(vec.proof)
        b[rng.randrange(256)] ^= 1 << rng.randrange(8)
        lanes.append(bytes(b))
    lanes.append(jbn.P.to_bytes(32, "big") + vec.proof[32:])
    outs = native_lib.parse_groth16_batch(b"".join(lanes), len(vec.proof), len(lanes))
    rinv = pow(FQ.r_mod, -1, pbn.P)

    def host(key, i):
        return limbs_batch_to_ints(outs[key][:, i:i + 1])[0] * rinv % pbn.P

    for i, buf in enumerate(lanes):
        try:
            proof = PS.load_groth16_proof_from_bytes(buf)
        except PE.VerifierError as e:
            # B off the twist is left to the device mask: valid here
            off_twist = str(e) == "G2 point not on twist curve"
            assert bool(outs["valid"][i]) == off_twist, i
            continue
        assert outs["valid"][i], i
        assert (host("ar_x", i), host("ar_y", i)) == proof.ar
        assert (host("krs_x", i), host("krs_y", i)) == proof.krs
        assert ((host("bs_x0", i), host("bs_x1", i)), (host("bs_y0", i), host("bs_y1", i))) == proof.bs


def test_native_packer_equals_python_packer(native_lib):
    rng = random.Random(66)
    vals = [rng.randrange(pbn.P) for _ in range(16)] + [0, pbn.P - 1]
    data = b"".join(v.to_bytes(32, "big") for v in vals)
    out, flags = native_lib.pack_be_batch(data, len(vals), "fq", to_mont=True)
    assert np.array_equal(out.astype(np.int64), FQ.pack(vals).astype(np.int64))
    assert not flags.any()

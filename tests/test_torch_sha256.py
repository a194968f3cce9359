"""The SHA-256 of kernel K7 (csrc/sha256.cuh) and its plain twin
(ops/plonk_lanes.py): the twin over lanes against hashlib at every block
edge, its start from a midstate against the whole message's hash, its
expand_message_xmd and hash to Fr against the JAX package's
utils/hash_to_field.py, and the g++ build of sha256.cuh against hashlib,
its word-wise fill starting at every byte of a word. Messages come from a
numpy seed."""

import hashlib
import shutil

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.utils.hash_to_field import WrappedHashToField, hash_to_field_bytes
from snark_bn254_verifier_tpu_torch.ops import plonk_lanes as PL
from snark_bn254_verifier_tpu_torch.ops.limbs import FR
from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn
from torch_host_build import one_torch_thread  # noqa: F401 (autouse)

# both sides of every block edge: a message of 55 bytes pads into one
# block, 56 into two; 119 and 120 the same a block later
LENGTHS = [0, 1, 55, 56, 63, 64, 65, 119, 120, 127, 128, 200]


def messages(n: int, lanes: int = 3, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed + n).integers(0, 256, size=(lanes, n), dtype=np.uint8)


@pytest.mark.parametrize("n", LENGTHS)
def test_sha256_twin_equals_hashlib(n):
    msgs = messages(n)
    got = PL.sha256(torch.as_tensor(msgs)).numpy()
    assert got.shape == (3, 32) and got.dtype == np.uint8
    for lane in range(3):
        assert got[lane].tobytes() == hashlib.sha256(msgs[lane].tobytes()).digest()


# (prefix, lane part): the gamma transcript's VK prefix is "gamma" and 9
# points (581 bytes: 9 blocks and 5 bytes over) for the synthetic VK
@pytest.mark.parametrize("prefix,tail", [(0, 5), (64, 0), (64, 55), (581, 56), (581, 261),
                                         (640, 119), (101, 120)])
def test_midstate_equals_whole_hash(prefix, tail):
    head = messages(prefix, lanes=1, seed=1)[0].tobytes()
    rest = messages(tail, seed=2)
    state, whole, left = PL.sha256_midstate(head)
    assert whole == prefix // 64 * 64 and left == head[whole:]
    lane_part = torch.cat([PL.const_bytes(left, 3, "cpu"), torch.as_tensor(rest)], 1)
    got = PL.sha256(lane_part, state, whole).numpy()
    for lane in range(3):
        assert got[lane].tobytes() == hashlib.sha256(head + rest[lane].tobytes()).digest()


@pytest.mark.parametrize("n", [0, 32, 64, 100])
def test_hash_to_field_twin_equals_reference(n):
    """expand_message_xmd's 48 bytes (b_0 continued from the Z_pad block's
    state) and their value mod r, in Montgomery form, against the JAX
    package's hash_to_field and its BSB22 wrapper."""
    msgs = messages(n, seed=3)
    got = PL.expand_msg_xmd(torch.as_tensor(msgs), PL.BSB22_DST, PL.HTF_BYTES).numpy()
    for lane in range(3):
        assert got[lane].tobytes() == hash_to_field_bytes(msgs[lane].tobytes(), b"BSB22-Plonk",
                                                          1)[0]
    if n == 64:  # a commitment's bytes: the value K7a folds in
        vals = FR.unpack(PL.hash_to_fr(torch.as_tensor(msgs)).numpy())
        for lane in range(3):
            htf = WrappedHashToField(b"BSB22-Plonk")
            htf.write(msgs[lane].tobytes())
            assert vals[lane] == int.from_bytes(htf.sum(), "big") % bn.R


def test_compressions_of_a_message():
    """One compression for 55 bytes, two for 56: what the bound counts."""
    seen = []
    real = PL.sha256_compress

    def counting(h, w):
        seen.append(w.shape[1])
        return real(h, w)

    PL.sha256_compress = counting
    try:
        PL.sha256(torch.as_tensor(messages(55)))
        PL.sha256(torch.as_tensor(messages(56)))
    finally:
        PL.sha256_compress = real
    assert seen == [3, 3, 3]


def host_lib():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    from snark_bn254_verifier_tpu_torch.ops import _build

    return _build.load_host_check(False)


@pytest.mark.parametrize("n", LENGTHS)
def test_sha256_host_build_equals_hashlib(n):
    """csrc/sha256.cuh built by g++ (csrc/host_check.cc): the context fed
    a byte at a time, padded and compressed, from the IV and from a
    midstate of a 581-byte prefix."""
    lib = host_lib()
    msg = messages(n, lanes=1)[0]
    buf = np.ascontiguousarray(msg if n else np.zeros(1, np.uint8))
    out = np.zeros(32, np.uint8)
    assert lib.host_sha256(buf.ctypes.data, n, None, 0, out.ctypes.data) == 0
    assert out.tobytes() == hashlib.sha256(msg.tobytes()).digest()
    head = messages(581, lanes=1, seed=1)[0].tobytes()
    state, whole, left = PL.sha256_midstate(head)
    mid = np.asarray(state, dtype=np.uint32)
    rest = np.concatenate([np.frombuffer(left, np.uint8), msg])
    assert lib.host_sha256(rest.ctypes.data, len(rest), mid.ctypes.data, whole,
                           out.ctypes.data) == 0
    assert out.tobytes() == hashlib.sha256(head + msg.tobytes()).digest()


# both sides of the 56-byte padding edge and of one and two block edges,
# counted from the byte where the words start
WORD_LENGTHS = [4, 51, 52, 53, 55, 56, 57, 60, 63, 64, 65, 68, 119, 120, 121, 127, 128, 129, 184]


@pytest.mark.parametrize("lead", [0, 1, 2, 3])
@pytest.mark.parametrize("n", WORD_LENGTHS)
def test_sha256_word_fill_host_build_equals_hashlib(lead, n):
    """sha256.cuh's word-wise fill (the g++ build): ``lead`` bytes a byte at
    a time, so the words that follow start at byte 0-3 of a word, then
    whole words and a last part word, padded and compressed; the digest
    equals hashlib's at lengths across the padding edge and one and two
    block edges."""
    lib = host_lib()
    msg = messages(lead + n, lanes=1, seed=lead)[0]
    out = np.zeros(32, np.uint8)
    assert lib.host_sha256_lead(msg.ctypes.data, len(msg), None, 0, lead, out.ctypes.data) == 0
    assert out.tobytes() == hashlib.sha256(msg.tobytes()).digest()

"""Kernel K7's plain twins (ops/plonk_lanes.py; the kernel is
csrc/plonk.cuh) against the JAX package's host passes, lane by lane, on
gen_plonk_vector(0) lanes with a bad lane of every kind
(fixtures/plonk_lanes.py):

  K7a  plonk_lanes_a_plain against PlonkBatchVerifier._lane_challenges and
       _lane_finish (snark_bn254_verifier_tpu/parallel/batch.py:642-733),
       the JAX loader's checks before them: zeta, the linearisation
       scalars and points, the valid bits, exactly;
  K7b  plonk_lanes_b_plain against the JAX verifier's fold (batch.py:575-600)
       on the same digests and randomisers;

a lane whose zeta is forced onto the domain is masked and its neighbours
are not; and the host's byte checks (pack_proofs)."""

import random

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.models import kzg as jax_kzg
from snark_bn254_verifier_tpu.parallel import batch as jax_batch
from snark_bn254_verifier_tpu.utils import serialization as jax_ser
from snark_bn254_verifier_tpu.utils.hash_to_field import WrappedHashToField
from snark_bn254_verifier_tpu_torch.fixtures.plonk_lanes import KINDS, plonk_batch_lanes
from snark_bn254_verifier_tpu_torch.models.packing import pack_fr_columns, pack_g1
from snark_bn254_verifier_tpu_torch.ops import plonk_lanes as PL
from snark_bn254_verifier_tpu_torch.ops.limbs import FQ, FR
from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn
from snark_bn254_verifier_tpu_torch.utils import serialization as ser
from torch_host_build import one_torch_thread  # noqa: F401 (autouse)

R = bn.R
# lane 0 and the last good, every kind between them
BAD = {1 + k: kind for k, kind in enumerate(KINDS)}
B = len(KINDS) + 2


@pytest.fixture(scope="module")
def lanes():
    return plonk_batch_lanes(B, BAD)


def lanes_vk(vk_bytes):
    return PL.LanesVk(ser.load_plonk_verifying_key_from_bytes(vk_bytes))


def run_a(proofs, inputs, lvk):
    """K7a's twin as PlonkBatchVerifier runs it: the host's byte checks and
    input count, the inputs packed canonical."""
    raw, valid = PL.pack_proofs(proofs, lvk)
    counted = np.array([len(ins) == lvk.nb_pub for ins in inputs])
    pub = pack_fr_columns([ins if c else None for ins, c in zip(inputs, counted)],
                           lvk.nb_pub, len(proofs))
    raw = torch.as_tensor(raw)
    return raw, PL.plonk_lanes_a_plain(raw, torch.as_tensor(pub),
                                       torch.as_tensor(valid & counted), lvk)


@pytest.fixture(scope="module")
def lane_a(lanes):
    vec, proofs, inputs, _ = lanes
    lvk = lanes_vk(vec.vk)
    return lvk, *run_a(proofs, inputs, lvk)


def jax_reference(vk_bytes, proof_bytes, inputs):
    """One lane by the JAX package: its loader, the count checks (the
    port's: one claimed value a digest, as kzg.fold_proof demands), the
    challenges, the batch inversion (a zero denominator masks the lane)
    and _lane_finish. Returns (zeta, lin_scalars, lin_points) or None."""
    jv = jax_batch.PlonkBatchVerifier(vk_bytes)
    vk = jv.vk
    try:
        proof = jax_ser.load_plonk_proof_from_bytes(proof_bytes)
    except Exception:  # noqa: BLE001 — the JAX verifier masks any parse failure
        return None
    if (len(proof.bsb22_commitments) != len(vk.qcp) or len(inputs) != vk.nb_public_variables
            or len(proof.batched_proof.claimed_values) != 6 + len(vk.qcp)):
        return None
    ch = jv._lane_challenges(proof, inputs)
    invs = jax_batch._batch_inv_mod_r(ch["denoms"])
    if any(v is None for v in invs):
        return None
    try:
        fin = jv._lane_finish(proof, inputs, ch, invs)
    except Exception:  # noqa: BLE001 — OpeningPolyMismatchError
        return None
    return ch["zeta"], fin["lin_scalars"], fin["lin_points"]


def lane_points(px, py, lane, rows):
    return [(FQ.unpack(px[j, :, lane:lane + 1].numpy())[0],
             FQ.unpack(py[j, :, lane:lane + 1].numpy())[0]) for j in rows]


@pytest.mark.parametrize("lane", range(B))
def test_lanes_a_equal_jax_lane_passes(lanes, lane_a, lane):
    vec, proofs, inputs, expected = lanes
    lvk, raw, (ok, zeta, (px, py, pinf), lin) = lane_a
    want = jax_reference(vec.vk, proofs[lane], inputs[lane])
    assert bool(ok[lane]) == (want is not None)
    if want is None:
        assert not zeta[:, lane].any() and not lin[:, :, lane].any()
        assert not px[:, :, lane].any() and not py[:, :, lane].any() and pinf[:, lane].all()
        return
    z, scalars, points = want
    assert FR.unpack(zeta[:, lane:lane + 1].numpy(), mont=False) == [z]
    assert FR.unpack(lin[:, :, lane].T.numpy(), mont=False) == scalars
    # K7a's rows: cmt_0..cmt_{nb-1}, l, r, o, z, h0, h1, h2, hb, hs
    proof = ser.load_plonk_proof_from_bytes(proofs[lane])
    nb = lvk.nb
    assert lane_points(px, py, lane, range(nb + 9)) == [
        *proof.bsb22_commitments, *proof.lro, proof.z, *proof.h, proof.batched_proof.h,
        proof.z_shifted_opening.h]
    assert points[:nb] + points[nb + 6:] == lane_points(px, py, lane,
                                                        [*range(nb), *range(nb + 3, nb + 7)])
    assert not pinf[:, lane].any()
    # only the doubled openings pass K7a and fail later, in the pairing
    assert expected[lane] or BAD[lane] in ("opening_doubled", "shifted_doubled")


def jax_fold(vk, proof, zeta, lin_digest, r_rand):
    """The JAX verifier's fold of one lane (parallel/batch.py:575-600):
    the combo MSM's scalars, then the quotient MSM's."""
    digests = [lin_digest, proof.lro[0], proof.lro[1], proof.lro[2], vk.s[0], vk.s[1]] + list(
        vk.qcp)
    cv = proof.batched_proof.claimed_values
    gamma_fold = jax_kzg.derive_gamma(zeta, digests, cv,
                                      jax_ser.fr_to_bytes_be(proof.z_shifted_opening.claimed_value))
    gpow = [1]
    for _ in range(len(digests) - 1):
        gpow.append(gpow[-1] * gamma_fold % R)
    folded_eval = sum(v * c for v, c in zip(cv, gpow)) % R
    shifted = zeta * vk.generator % R
    zu = proof.z_shifted_opening.claimed_value
    fe_total = (folded_eval + r_rand * zu) % R
    return gpow + [r_rand, (-fe_total) % R, zeta, r_rand * shifted % R] + [1, r_rand]


@pytest.fixture(scope="module")
def lane_b(lanes, lane_a):
    """K7b's twin on K7a's lanes, a seeded digest a lane (lane 0's at
    infinity) and seeded randomisers."""
    lvk, raw, (ok, zeta, _, _) = lane_a
    rng = random.Random(5)
    digests = [None] + [bn.g1_mul(bn.G1_GEN, rng.randrange(1, R)) for _ in range(B - 1)]
    rands = [rng.randrange(1, R) for _ in range(B)]
    dx, dy, dinf = (torch.as_tensor(a) for a in pack_g1(digests))
    rand = torch.as_tensor(pack_fr_columns([[r] for r in rands], 1, B)[0])
    sc = PL.plonk_lanes_b_plain(raw, ok, zeta, rand, (dx, dy, dinf), lvk)
    return digests, rands, sc


@pytest.mark.parametrize("lane", range(B))
def test_lanes_b_equal_jax_fold(lanes, lane_a, lane_b, lane):
    vec, proofs, _, _ = lanes
    lvk, _, (ok, zeta, _, _) = lane_a
    digests, rands, sc = lane_b
    assert sc.shape == (lvk.nb + 12, 16, B) and sc.dtype == torch.int32
    if not ok[lane]:
        assert not sc[:, :, lane].any()
        return
    vk = jax_ser.load_plonk_verifying_key_from_bytes(vec.vk)
    z = FR.unpack(zeta[:, lane:lane + 1].numpy(), mont=False)[0]
    want = jax_fold(vk, jax_ser.load_plonk_proof_from_bytes(proofs[lane]), z, digests[lane],
                    rands[lane])
    assert FR.unpack(sc[:, :, lane].T.numpy(), mont=False) == want


def restated(vec, inputs):
    """vec's proof with claimed value 0 made to satisfy the early check
    for ``inputs`` (plonk/verify.rs:98-210 on the JAX verifier's
    challenges): a lane with its own zeta that passes K7a (and fails the
    pairing later)."""
    jv = jax_batch.PlonkBatchVerifier(vec.vk)
    vk = jv.vk
    proof = jax_ser.load_plonk_proof_from_bytes(vec.proof)
    ch = jv._lane_challenges(proof, inputs)
    invs = jax_batch._batch_inv_mod_r(ch["denoms"])
    gamma, beta, alpha = ch["gamma"], ch["beta"], ch["alpha"]
    zh = (ch["zeta_n"] - 1) % R
    l1 = invs[0] * zh * vk.size_inv % R
    pi = sum(zh * invs[1 + j] * vk.size_inv * jv._w_pows[j] * (w % R)
             for j, w in enumerate(inputs))
    for i, w_pow_i in enumerate(jv._cci_wpow):
        htf = WrappedHashToField(b"BSB22-Plonk")
        htf.write(jax_ser.g1_to_bytes(proof.bsb22_commitments[i]))
        hashed = int.from_bytes(htf.sum(), "big") % R
        pi += zh * w_pow_i * invs[1 + len(inputs) + i] * vk.size_inv * hashed
    cv = proof.batched_proof.claimed_values
    l, r_, o, s1, s2 = cv[1:6]
    zu = proof.z_shifted_opening.claimed_value
    cl = (beta * s1 + gamma + l) * (beta * s2 + gamma + r_) * (o + gamma) * alpha * zu
    cl = -(cl - l1 * alpha * alpha + pi) % R
    out = vec.proof[:516] + cl.to_bytes(32, "big") + vec.proof[548:]
    assert jax_reference(vec.vk, out, inputs) is not None
    return out


def test_zeta_on_the_domain_masks_its_lane_alone():
    """The VK's first input point w^0 moved onto the good proof's zeta:
    the good lanes' denominator zeta - w^0 is zero and they are masked;
    their neighbours, a proof restated for a first input of 0 (its own
    zeta; that input's Lagrange term is zero at any point), stay valid."""
    vec, proofs, inputs, _ = plonk_batch_lanes(1, {})
    ins0 = [0] + list(inputs[0][1:])
    other = restated(vec, ins0)
    proofs, inputs = [proofs[0], other] * 2, [inputs[0], ins0] * 2
    lvk = lanes_vk(vec.vk)
    _, (ok, zeta, _, _) = run_a(proofs, inputs, lvk)
    assert ok.tolist() == [True] * 4
    zeta_good = FR.unpack(zeta[:, :1].numpy(), mont=False)[0]
    assert zeta_good != FR.unpack(zeta[:, 1:2].numpy(), mont=False)[0]
    lvk.w_pows = (zeta_good,) + lvk.w_pows[1:]
    _, (ok, zeta, _, lin) = run_a(proofs, inputs, lvk)
    assert ok.tolist() == [False, True, False, True]
    assert not zeta[:, 0].any() and not lin[:, :, 2].any() and zeta[:, 1].any()


@pytest.mark.parametrize("kind,valid", [("truncated", False), ("extra_claimed", False),
                                        ("noncanonical_x", True), ("wrong_count", True)])
def test_pack_proofs_byte_checks(kind, valid):
    """The host masks a short proof and a wrong count of claimed values,
    and leaves every check that needs arithmetic (and the input count,
    which the verifier checks) to others; a longer proof is cut to L."""
    vec, proofs, _, _ = plonk_batch_lanes(3, {1: kind})
    lvk = lanes_vk(vec.vk)
    proofs[2] = proofs[2] + b"\x07" * 9
    raw, ok = PL.pack_proofs(proofs, lvk)
    assert raw.shape == (3, lvk.proof_len) == (3, len(vec.proof))
    assert ok.tolist() == [True, valid, True]
    assert raw[0].tobytes() == raw[2].tobytes() == vec.proof
    assert raw[1].any() == valid


def test_lanes_vk_blob_layout(lanes):
    """The words K7 reads (csrc/plonk.cuh's PV_* offsets)."""
    lvk = lanes_vk(lanes[0].vk)
    words = lvk.blob()
    assert words.dtype == np.uint32
    assert words[:6].tolist() == [2, 1, 576, 5, 8, 0]  # "gamma" + 9 points: 581 bytes
    assert words[14:30].view(np.uint8)[:5].tobytes() == lvk.tail
    fr = words[38:38 + 8 * 6].reshape(6, 8)
    consts = [lvk.size_inv, lvk.generator, lvk.coset_shift, 1, lvk.generator,
              pow(lvk.generator, 3, R)]
    assert [FR.from_mont_int(sum(int(w) << (32 * k) for k, w in enumerate(row)))
            for row in fr] == consts
    assert words[38 + 48:].view(np.uint8).tobytes() == lvk.digests
    assert len(lvk.digests) == 64 * 3


def test_zeta_on_the_domain_host_build():
    """The same forced lanes through K7a's lane body built by g++
    (csrc/host_check.cc): the good lanes masked, the restated ones valid,
    every output equal to the twin's."""
    import shutil

    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    from snark_bn254_verifier_tpu_torch.ops import _build

    lib = _build.load_host_check(False)
    vec, proofs, inputs, _ = plonk_batch_lanes(1, {})
    ins0 = [0] + list(inputs[0][1:])
    proofs, inputs = [proofs[0], restated(vec, ins0)] * 2, [inputs[0], ins0] * 2
    lvk = lanes_vk(vec.vk)
    raw, (_, zeta, _, _) = run_a(proofs, inputs, lvk)
    lvk.w_pows = (FR.unpack(zeta[:, :1].numpy(), mont=False)[0],) + lvk.w_pows[1:]
    raw, twin = run_a(proofs, inputs, lvk)
    pub = torch.as_tensor(pack_fr_columns(inputs, lvk.nb_pub, 4))
    valid = torch.ones(4, dtype=torch.bool)
    words = torch.as_tensor(lvk.blob().view(np.int32))
    m = lvk.nb + 9
    ok, z = torch.zeros(4, dtype=torch.bool), torch.zeros((16, 4), dtype=torch.int32)
    px, py = (torch.zeros((m, 16, 4), dtype=torch.int32) for _ in range(2))
    pinf = torch.zeros((m, 4), dtype=torch.bool)
    lin = torch.zeros((lvk.nb + 10, 16, 4), dtype=torch.int32)
    assert lib.host_plonk_lanes_a(*(t.data_ptr() for t in (raw,)), lvk.proof_len,
                                  *(t.data_ptr() for t in (pub, valid, words, ok, z, px, py,
                                                           pinf, lin)), 4) == 0
    assert ok.tolist() == [False, True, False, True]
    assert torch.equal(ok, twin[0]) and torch.equal(z, twin[1]) and torch.equal(lin, twin[3])
    assert all(torch.equal(a, b) for a, b in zip((px, py, pinf), twin[2]))

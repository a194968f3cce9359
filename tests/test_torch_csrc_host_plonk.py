"""K7a and K7b (plonk.cuh) built for the host (csrc/host_check.cc: a block
at a time, its shared memory poisoned, each stage through every thread of
the block before the next, first to last or last to first), against the
plain twins on lanes of every bad kind, and K7a's divsteps inverse
against the twin's Fermat inverse. Skips where no host C++ compiler is
installed."""

import random

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu_torch.models.packing import pack_fr_columns, pack_g1
from snark_bn254_verifier_tpu_torch.ops import field as F
from snark_bn254_verifier_tpu_torch.ops.limbs import FR
from torch_host_build import c_tensor, lib, one_torch_thread, ptr  # noqa: F401 (autouse)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fr_inverse_divsteps_equals_fermat_twin(lib, seed):
    """K7a's inverse (plonk.cuh::fr_inv: Bernstein-Yang divsteps, then a
    product by R^3) of Montgomery elements: limb-equal to the plain twin's
    Fermat a^(r-2) (ops/field.py::inv) and the oracle's, zero to zero, on
    seeded values and the edges 0, 1, r - 1 and values with their high
    words set."""
    rng = np.random.default_rng(70 + seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % bn.R for _ in range(24)]
    vals += [0, 1, 2, bn.R - 1, bn.R - 2, 1 << 253, bn.R - (1 << 200), (1 << 253) | 1,
             bn.R >> 1, (bn.R >> 32) << 32]
    a = c_tensor(FR.pack(vals))
    out = torch.empty_like(a)
    assert lib.host_fr_inv(ptr(a), ptr(out), a.shape[1]) == 0
    assert FR.unpack(out.numpy()) == [pow(v, bn.R - 2, bn.R) for v in vals]
    assert torch.equal(out, F.inv(FR, a.to(torch.int64)).to(torch.int32))


def host_plonk_lanes(lib, raw, pub, valid, lvk, reverse=0):
    """K7a then K7b (csrc/plonk.cuh) block by block on the host build (with
    ``reverse`` each stage's threads last to first): K7a's outputs and
    K7b's scalars over a seeded digest a lane (lane 0's at infinity) and
    seeded randomisers, with those inputs."""
    from snark_bn254_verifier_tpu_torch.ops import plonk_lanes as PL

    b, m = raw.shape[0], lvk.nb + 9
    words = torch.as_tensor(lvk.blob().view(np.int32))
    ok = torch.zeros(b, dtype=torch.bool)
    zeta = torch.zeros((16, b), dtype=torch.int32)
    px, py = torch.zeros((m, 16, b), dtype=torch.int32), torch.zeros((m, 16, b), dtype=torch.int32)
    pinf = torch.zeros((m, b), dtype=torch.bool)
    lin = torch.zeros((lvk.nb + 10, 16, b), dtype=torch.int32)
    assert lib.host_plonk_lanes_a_ordered(ptr(raw), lvk.proof_len, ptr(pub), ptr(valid),
                                          ptr(words), ptr(ok), ptr(zeta), ptr(px), ptr(py),
                                          ptr(pinf), ptr(lin), b, reverse) == 0
    rng = random.Random(9)
    digests = [None] + [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(b - 1)]
    dx, dy, dinf = (c_tensor(a) for a in pack_g1(digests))
    rand = c_tensor(pack_fr_columns([[rng.randrange(1, bn.R)] for _ in range(b)], 1, b)[0])
    sc = torch.zeros((lvk.nb + 12, 16, b), dtype=torch.int32)
    assert lib.host_plonk_lanes_b_ordered(ptr(raw), lvk.proof_len, ptr(ok), ptr(zeta),
                                          ptr(rand), ptr(dx), ptr(dy), ptr(dinf), ptr(words),
                                          ptr(sc), b, reverse) == 0
    return (ok, zeta, (px, py, pinf), lin), ((dx, dy, dinf), rand, sc)


def plonk_host_lanes_of_every_kind(n_bsb22=1):
    """A lane of every kind of fixtures/plonk_lanes.py and two good ones,
    packed as the verifier packs them: (raw, pub, valid, lvk, bad,
    expected)."""
    from snark_bn254_verifier_tpu_torch.fixtures.plonk_lanes import KINDS, plonk_batch_lanes
    from snark_bn254_verifier_tpu_torch.ops import plonk_lanes as PL
    from snark_bn254_verifier_tpu_torch.utils import serialization as ser

    bad = {1 + k: kind for k, kind in enumerate(KINDS)}
    vec, proofs, inputs, expected = plonk_batch_lanes(len(KINDS) + 2, bad, n_bsb22)
    lvk = PL.LanesVk(ser.load_plonk_verifying_key_from_bytes(vec.vk))
    raw, valid = PL.pack_proofs(proofs, lvk)
    counted = np.array([len(ins) == lvk.nb_pub for ins in inputs])
    pub = pack_fr_columns([ins if c else None for ins, c in zip(inputs, counted)],
                           lvk.nb_pub, len(proofs))
    raw, pub, valid = c_tensor(raw), c_tensor(pub), c_tensor(valid & counted)
    return raw, pub, valid, lvk, bad, expected


def assert_host_plonk_lanes_equal_twins(lib, lanes, reverse):
    from snark_bn254_verifier_tpu_torch.ops import plonk_lanes as PL

    raw, pub, valid, lvk, bad, expected = lanes
    (ok, zeta, pts, lin), (digest, rand, sc) = host_plonk_lanes(lib, raw, pub, valid, lvk,
                                                                reverse)
    t_ok, t_zeta, t_pts, t_lin = PL.plonk_lanes_a_plain(raw, pub, valid, lvk)
    assert torch.equal(ok, t_ok) and torch.equal(zeta, t_zeta) and torch.equal(lin, t_lin)
    assert all(torch.equal(a, b) for a, b in zip(pts, t_pts))
    doubled = [i for i, k in bad.items() if k in ("opening_doubled", "shifted_doubled")]
    assert ok.tolist() == [e or i in doubled for i, e in enumerate(expected)]
    assert torch.equal(sc, PL.plonk_lanes_b_plain(raw, ok, zeta, rand, digest, lvk))
    assert sc[:, :, ok].any() and not sc[:, :, ~ok].any()


def test_plonk_lanes_host_build_equals_plain_twins(lib):
    """K7a and K7b's lane bodies built by g++, on a lane of every kind of
    fixtures/plonk_lanes.py (the new non-canonical and off-curve kinds
    among them): every output limb for limb equal to their plain twins
    (which tests/test_torch_plonk_lanes.py holds against the JAX
    package's host passes), the valid bits the expected verdicts but the
    doubled openings', which fail in the pairing."""
    assert_host_plonk_lanes_equal_twins(lib, plonk_host_lanes_of_every_kind(), 0)


def test_plonk_lanes_host_build_in_reverse_thread_order(lib):
    """The same lanes with each stage's threads run last to first (the
    shared memory poisoned before each block, as in every order): a stage
    that read a slot another warp writes in the same stage, a race on the
    card, would read the poison or a stale value in one of the two
    orders; both equal the twins."""
    assert_host_plonk_lanes_equal_twins(lib, plonk_host_lanes_of_every_kind(), 1)


@pytest.mark.parametrize("n_bsb22", [2, 3])
def test_plonk_lanes_host_build_at_more_commitments(lib, n_bsb22):
    """A VK of 2 and 3 BSB22 commitments (longer rows, more slots, more
    hashes: past 48 KB of shared memory on the card, K7b from 2, K7a
    from 3), a lane of every kind, both thread orders, equal to the
    twins."""
    lanes = plonk_host_lanes_of_every_kind(n_bsb22)
    assert lanes[3].nb == n_bsb22
    for reverse in (0, 1):
        assert_host_plonk_lanes_equal_twins(lib, lanes, reverse)


def test_plonk_shared_memory_ceiling_is_the_wrappers(lib):
    """K7's dynamic shared bytes a block (the host build of plonk.cuh's
    layout): 45,056 (K7a) and 46,464 (K7b) at one commitment, above
    48 KB from 2 (K7b) and 3 (K7a), so the entry raises the kernel's limit
    there; the most commitments that fit 227 KB (232,448 B) is 37, set by
    K7b, and the wrappers refuse more on the card."""
    from types import SimpleNamespace

    from snark_bn254_verifier_tpu_torch.ops import plonk_cuda as PCU
    from snark_bn254_verifier_tpu_torch.ops.plonk_lanes import proof_bytes

    def smem(nb, lanes_a):
        return lib.host_plonk_smem_bytes(proof_bytes(nb), nb, int(lanes_a))

    assert (smem(1, True), smem(1, False)) == (45_056, 46_464)
    assert smem(2, True) <= 48 * 1024 < smem(2, False) and smem(3, True) > 48 * 1024
    assert lib.host_plonk_max_nb() == PCU.K7_MAX_NB == 37
    assert max(smem(37, True), smem(37, False)) <= 232_448 < smem(38, False)
    PCU.check_nb(SimpleNamespace(nb=37))
    with pytest.raises(ValueError, match="at most 37 BSB22 commitments"):
        PCU.check_nb(SimpleNamespace(nb=38))

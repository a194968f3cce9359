"""The CUDA kernels' arithmetic, built for the host: csrc/*.cuh compiled by
the host C++ compiler into a test-only library (csrc/host_check.cc,
tests/torch_host_build.py) and run against the oracle and the plain twins,
without a card. This file: the 16<->32-bit limb conversion, the 32-bit
CIOS in both forms, the Fq inverses, the fused K1's G2 on-curve mask and
the teams' Fq12 product (each thread of a block a fiber). The other units'
host builds are in tests/test_torch_csrc_host_{msm,pairing,pippenger,plonk}.py,
g2_lines' in tests/test_torch_g2_lines.py. Each kernel's code runs with the
form of the Montgomery product its unit runs on the card. Skips where no
host C++ compiler is installed."""

import random

import pytest
import torch

from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu_torch.fixtures.g2_lanes import g2_mask_lanes
from snark_bn254_verifier_tpu_torch.models.packing import pack_fq12, unpack_fq12
from snark_bn254_verifier_tpu_torch.ops import field as F
from snark_bn254_verifier_tpu_torch.ops.limbs import FQ, FR
from torch_host_build import (  # noqa: F401 (one_torch_thread: autouse)
    c_tensor,
    lib,
    lib_rolled,
    one_torch_thread,
    ptr,
)


@pytest.mark.parametrize("rolled", [0, 1])
@pytest.mark.parametrize("name", ["fq", "fr"])
def test_fp_mul_matches_oracle_and_plain_twin(lib, name, rolled):
    """The CIOS product in both forms (K2 and K5 run the rolled one)."""
    spec = FQ if name == "fq" else FR
    rng = random.Random(51)
    va = [rng.randrange(spec.modulus) for _ in range(6)] + [0, spec.modulus - 1]
    vb = [rng.randrange(spec.modulus) for _ in range(6)] + [spec.modulus - 1, spec.modulus - 1]
    a, b = c_tensor(spec.pack(va)), c_tensor(spec.pack(vb))
    out = torch.empty_like(a)
    assert lib.host_mont_mul(ptr(a), ptr(b), ptr(out), a.shape[1],
                             0 if name == "fq" else 1, rolled) == 0
    assert spec.unpack(out.numpy()) == [x * y % spec.modulus for x, y in zip(va, vb)]
    assert torch.equal(out, F.mont_mul(spec, a, b))


@pytest.mark.parametrize("binary", [0, 1])
def test_fq_inverse_matches_oracle(lib, lib_rolled, binary):
    """Fermat (K4's) and binary Euclid (K2's) inverses of Montgomery
    elements, each with its kernel's product: limb-equal to the oracle's,
    zero to zero."""
    rng = random.Random(50)
    vals = [rng.randrange(bn.P) for _ in range(8)] + [0, 1, 2, bn.P - 1, 1 << 200]
    a = c_tensor(FQ.pack(vals))
    out = torch.empty_like(a)
    host = lib_rolled if binary else lib
    assert host.host_fq_inv(ptr(a), ptr(out), a.shape[1], binary) == 0
    assert FQ.unpack(out.numpy()) == [pow(v, bn.P - 2, bn.P) for v in vals]


@pytest.mark.parametrize("n", [1, 33, 130])
def test_g2_on_curve_lanes_equal_plain_twin(lib, n):
    """The fused K1's lane body (curve.cuh::g2_on_curve_lane, K1's unrolled
    Montgomery product) over a ragged lane count, lane for lane equal to
    its plain twin and to the oracle's valid && (inf || on the curve)."""
    from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC

    x, y, inf, valid, want = g2_mask_lanes(80 + n, n)
    tx, ty, tinf, tvalid = (c_tensor(a) for a in (x, y, inf, valid))
    out = torch.empty(n, dtype=torch.bool)
    assert lib.host_g2_on_curve(ptr(tx), ptr(ty), ptr(tinf), ptr(tvalid), ptr(out), n) == 0
    assert torch.equal(out, PC.g2_on_curve((tx, ty, tinf), tvalid))
    assert out.tolist() == want
    if n > 1:
        assert 0 < sum(want) < n


def test_fq12_mul_matches_oracle(lib, lib_rolled):
    """team.cuh's Fq12 product as each team kernel runs it: K4's team of 12
    (8 lanes a block) and K3's of 18 (4 lanes a block) with the unrolled
    Montgomery product, K5's of 18 with the rolled one. 9 lanes (ragged
    blocks) of random values, zero, one and every coefficient p - 1."""
    rng = random.Random(52)

    def rand12():
        return tuple(tuple((rng.randrange(bn.P), rng.randrange(bn.P)) for _ in range(3))
                     for _ in range(2))

    top = tuple(tuple((bn.P - 1, bn.P - 1) for _ in range(3)) for _ in range(2))
    xs = [rand12() for _ in range(6)] + [bn.FQ12_ZERO, top, bn.FQ12_ONE]
    ys = [rand12() for _ in range(6)] + [rand12(), top, rand12()]
    a, b = c_tensor(pack_fq12(xs)), c_tensor(pack_fq12(ys))
    want = [bn.fq12_mul(x, y) for x, y in zip(xs, ys)]
    for host, team in ((lib, 12), (lib, 18), (lib_rolled, 18)):
        out = torch.empty_like(a)
        assert host.host_fq12_mul(ptr(a), ptr(b), ptr(out), len(xs), team) == 0
        assert unpack_fq12(out.numpy()) == want, (team, host is lib_rolled)

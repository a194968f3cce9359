"""PyTorch port, pairing layer: the plain twins of kernels K3 (mixed Miller
product), K4 (x-chain final exponentiation) and K5 (Miller product of
variable pairs).

Tier-1: final_exp(miller_mixed(...)) equals the oracle's product of
pairings, with infinity lanes, for the Groth16 shape (one variable pair +
two fixed) and the fixed-only shape; final_exp(miller_product(...))
equals it for 1, 2 and 3 variable pairs with infinite P and infinite Q
lanes. Slow (XLA:CPU compiles, as tests/test_lines.py): the Miller outputs
are limb-equal to the JAX package's miller_mixed_hostcall and
miller_product_jit, and the final exponentiation equals its
final_exponentiation_jit. Exact equality throughout."""

import random

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu.ops import lines as JLN
from snark_bn254_verifier_tpu.ops import pairing as JPR
from snark_bn254_verifier_tpu_torch.models.packing import (
    pack_g1,
    pack_g2,
    pair_major,
    unpack_fq12,
)
from snark_bn254_verifier_tpu_torch.ops import lines as LN
from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC
from torch_host_build import one_torch_thread  # noqa: F401 (autouse)


def case(seed, b, with_var):
    rng = random.Random(seed)
    q_fixed = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    fixed_lanes = [[bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(b)]
                   for _ in range(2)]
    fixed_lanes[0][1] = None  # a fixed pair at infinity
    var = None
    if with_var:
        vp = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(b)]
        vq = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(b)]
        vp[b - 1] = None  # the variable pair at infinity
        var = (vp, vq)
    return q_fixed, fixed_lanes, var


def oracle_lane(lane, q_fixed, fixed_lanes, var):
    pairs = [(fixed_lanes[j][lane], q_fixed[j]) for j in range(2)
             if fixed_lanes[j][lane] is not None]
    if var is not None and var[0][lane] is not None:
        pairs.append((var[0][lane], var[1][lane]))
    return bn.pairing_batch(pairs)


def port_args(q_fixed, fixed_lanes, var):
    def t(tup):
        return tuple(torch.as_tensor(x) for x in tup)

    lines, tails = LN.tables_from_numpy([LN.g2_line_table(q) for q in q_fixed])
    fixed = tuple(t(pack_g1(lane)) for lane in fixed_lanes)
    vp, vq = (t(pack_g1(var[0])), t(pack_g2(var[1]))) if var else (None, None)
    return vp, vq, fixed, lines, tails


@pytest.mark.parametrize("with_var,b", [(True, 3), (False, 2)],
                         ids=["groth16_shape", "fixed_only"])
def test_final_exp_of_miller_mixed_matches_oracle(with_var, b):
    q_fixed, fixed_lanes, var = case(31 + b, b, with_var)
    f = PC.miller_mixed(*port_args(q_fixed, fixed_lanes, var))
    assert f.shape == (16, 12, b) and f.dtype == torch.int32
    gt = unpack_fq12(PC.final_exp(f).numpy())
    for lane in range(b):
        assert gt[lane] == oracle_lane(lane, q_fixed, fixed_lanes, var), lane


def jax_tuple(tup):
    return tuple(x.astype(np.uint32) if x.dtype != bool else x for x in tup)


@pytest.mark.slow
def test_miller_limb_equal_and_final_exp_equal_to_jax():
    q_fixed, fixed_lanes, var = case(41, 4, True)
    vp, vq, fixed, lines, tails = port_args(q_fixed, fixed_lanes, var)
    f = PC.miller_mixed(vp, vq, fixed, lines, tails)
    jf = JPR.miller_mixed_hostcall(
        jax_tuple(pack_g1(var[0])), jax_tuple(pack_g2(var[1])),
        tuple(jax_tuple(pack_g1(lane)) for lane in fixed_lanes),
        tuple(JLN.g2_line_table(q) for q in q_fixed),
    )
    assert np.array_equal(f.numpy().astype(np.int64), np.asarray(jf).astype(np.int64))
    gt = PC.final_exp(f)
    jgt = JPR.final_exponentiation_jit(jf)
    assert np.array_equal(gt.numpy().astype(np.int64), np.asarray(jgt).astype(np.int64))


def product_case(seed, n, b):
    """n variable pairs over b lanes, per-pair lane lists (None =
    infinity): lane 0 has the first P at infinity, lane 1 the last Q."""
    rng = random.Random(seed)
    ps = [[bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(b)] for _ in range(n)]
    qs = [[bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(b)] for _ in range(n)]
    ps[0][0] = None
    qs[n - 1][1] = None
    return ps, qs


def oracle_product(ps, qs, lane):
    return bn.pairing_batch([(p[lane], q[lane]) for p, q in zip(ps, qs)])


PRODUCT_B = 3


@pytest.fixture(scope="module")
def products():
    """final_exp(miller_product) of 1, 2 and 3 pairs over PRODUCT_B lanes,
    the three Miller values finished by one final exponentiation."""
    cases, fs = {}, []
    for n in (1, 2, 3):
        ps, qs = product_case(70 + n, n, PRODUCT_B)
        P, Q = (tuple(torch.as_tensor(x) for x in pair_major(pack, lanes))
                for pack, lanes in ((pack_g1, ps), (pack_g2, qs)))
        f = PC.miller_product(P, Q)
        assert f.shape == (16, 12, PRODUCT_B) and f.dtype == torch.int32
        cases[n] = (ps, qs)
        fs.append(f)
    gt = unpack_fq12(PC.final_exp(torch.cat(fs, -1)).numpy())
    return {n: (ps, qs, gt[k * PRODUCT_B:(k + 1) * PRODUCT_B])
            for k, (n, (ps, qs)) in enumerate(cases.items())}


@pytest.mark.parametrize("n", [1, 2, 3])
def test_final_exp_of_miller_product_matches_oracle(products, n):
    ps, qs, gt = products[n]
    for lane in range(PRODUCT_B):
        assert gt[lane] == oracle_product(ps, qs, lane), lane


def test_miller_product_needs_a_pair():
    P = (torch.zeros((0, 16, 1), dtype=torch.int32),) * 2 + (torch.zeros((0, 1), dtype=torch.bool),)
    Q = (torch.zeros((0, 16, 2, 1), dtype=torch.int32),) * 2 + (P[2],)
    with pytest.raises(ValueError):
        PC.miller_product(P, Q)


@pytest.mark.slow
def test_miller_product_limb_equal_to_jax():
    """The twin against the XLA tier of what _miller_kernel +
    _fq12_product_kernel compute, on the JAX backend's own packing."""
    from snark_bn254_verifier_tpu.models import jax_backend as JB

    n, b = 3, 2
    ps, qs = product_case(81, n, b)
    jp = [JB.pack_g1(lane) for lane in ps]
    jq = [JB.pack_g2(lane) for lane in qs]
    P = tuple(np.stack([x[i] for x in jp]) for i in range(3))
    Q = tuple(np.stack([x[i] for x in jq]) for i in range(3))
    jf = JPR.miller_product_jit(jax_tuple(P), jax_tuple(Q))
    f = PC.miller_product(tuple(torch.as_tensor(x.astype(np.int32) if x.dtype != bool else x)
                                for x in P),
                          tuple(torch.as_tensor(x.astype(np.int32) if x.dtype != bool else x)
                                for x in Q))
    assert np.array_equal(f.numpy().astype(np.int64), np.asarray(jf).astype(np.int64))

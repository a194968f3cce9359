"""PyTorch port, pairing layer: the plain twins of kernels K3 (mixed Miller
product) and K4 (x-chain final exponentiation).

Tier-1: final_exp(miller_mixed(...)) equals the oracle's product of
pairings, with infinity lanes, for the Groth16 shape (one variable pair +
two fixed) and the fixed-only shape. Slow (XLA:CPU compiles, as
tests/test_lines.py): the Miller output is limb-equal to the JAX
package's miller_mixed_hostcall, and the final exponentiation equals its
final_exponentiation_jit. Exact equality throughout."""

import random

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu.ops import lines as JLN
from snark_bn254_verifier_tpu.ops import pairing as JPR
from snark_bn254_verifier_tpu_torch.models.packing import pack_g1, pack_g2, unpack_fq12
from snark_bn254_verifier_tpu_torch.ops import lines as LN
from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC


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

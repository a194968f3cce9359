"""PyTorch port, tower layer: ops/tower.py against the JAX package's
ops/tower.py (same layout, same inputs) and the oracle. Exact equality."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu.ops import tower as JT
from snark_bn254_verifier_tpu_torch.models.packing import pack_fq12, unpack_fq12
from snark_bn254_verifier_tpu_torch.ops import tower as T

B = 4


def rand_comps(seed, comps):
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(16, comps, B), dtype=np.int64)
    limbs[15] = rng.integers(0, bn.P >> 240, size=(comps, B))
    return limbs.astype(np.int32)


def same(port, jax_out):
    assert np.array_equal(port.numpy(), np.asarray(jax_out).astype(np.int64))


def both(x):
    return torch.as_tensor(x), jnp.asarray(x.astype(np.uint32))


BINARY = [
    ("fq2_mul", 2, T.fq2_mul, JT.fq2_mul),
    ("fq6_mul", 6, T.fq6_mul, JT.fq6_mul),
    ("fq12_mul", 12, T.fq12_mul, JT.fq12_mul),
]
UNARY = [
    ("fq2_mul_xi", 2, T.fq2_mul_xi, JT.fq2_mul_xi),
    ("fq2_conj", 2, T.fq2_conj, JT.fq2_conj),
    ("fq2_inv", 2, T.fq2_inv, JT.fq2_inv),
    ("fq6_inv", 6, T.fq6_inv, JT.fq6_inv),
    ("fq12_sq", 12, T.fq12_sq, JT.fq12_sq),
    ("fq12_conj", 12, T.fq12_conj, JT.fq12_conj),
    ("fq12_inv", 12, T.fq12_inv, JT.fq12_inv),
    ("fq12_frobenius_1", 12, lambda a: T.fq12_frobenius(a, 1), lambda a: JT.fq12_frobenius(a, 1)),
    ("fq12_frobenius_2", 12, lambda a: T.fq12_frobenius(a, 2), lambda a: JT.fq12_frobenius(a, 2)),
    ("fq12_frobenius_3", 12, lambda a: T.fq12_frobenius(a, 3), lambda a: JT.fq12_frobenius(a, 3)),
    ("fq12_cyclotomic_sq", 12, T.fq12_cyclotomic_sq, JT.fq12_cyclotomic_sq),
]


@pytest.mark.parametrize("name,comps,port,ref", BINARY, ids=[c[0] for c in BINARY])
def test_binary_matches_jax(name, comps, port, ref):
    (ta, ja), (tb, jb) = both(rand_comps(1, comps)), both(rand_comps(2, comps))
    same(port(ta, tb), jax.jit(ref)(ja, jb))


@pytest.mark.parametrize("name,comps,port,ref", UNARY, ids=[c[0] for c in UNARY])
def test_unary_matches_jax(name, comps, port, ref):
    ta, ja = both(rand_comps(3, comps))
    same(port(ta), jax.jit(ref)(ja))


def test_fq12_ops_match_oracle():
    rng = random.Random(4)
    vals = [
        tuple(tuple((rng.randrange(bn.P), rng.randrange(bn.P)) for _ in range(3))
              for _ in range(2))
        for _ in range(2)
    ]
    a = torch.as_tensor(pack_fq12(vals))
    b = torch.as_tensor(pack_fq12(vals[::-1]))
    assert unpack_fq12(T.fq12_mul(a, b).numpy()) == [
        bn.fq12_mul(x, y) for x, y in zip(vals, vals[::-1])
    ]
    assert unpack_fq12(T.fq12_inv(a).numpy()) == [bn.fq12_inv(x) for x in vals]
    assert unpack_fq12(T.fq12_frobenius(a, 1).numpy()) == [
        bn.fq12_frobenius(x) for x in vals
    ]


def test_cyclotomic_sq_equals_sq_in_the_subgroup():
    """After the easy part of the final exponentiation the value is in the
    cyclotomic subgroup, where Granger-Scott squaring is plain squaring."""
    f = torch.as_tensor(rand_comps(5, 12))
    m = T.fq12_mul(T.fq12_conj(f), T.fq12_inv(f))
    m = T.fq12_mul(T.fq12_frobenius(m, 2), m)
    assert torch.equal(T.fq12_cyclotomic_sq(m), T.fq12_sq(m))

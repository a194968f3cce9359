"""PyTorch port, field layer: ops/limbs.py + ops/field.py (the plain twin of
kernel K1) against the JAX package's XLA-tier field ops and the oracle.

Integer field arithmetic: every comparison is exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu.ops import field as JF
from snark_bn254_verifier_tpu_torch.ops import field as F
from snark_bn254_verifier_tpu_torch.ops import field_cuda as FC
from snark_bn254_verifier_tpu_torch.ops.limbs import FQ, FR, limbs_batch_to_ints
from torch_host_build import one_torch_thread  # noqa: F401 (autouse)

B = 8


def rand_limbs(rng, modulus, shape):
    """Values below the modulus's top limb, (16, *shape) int32."""
    limbs = rng.integers(0, 1 << 16, size=(16,) + tuple(shape), dtype=np.int64)
    limbs[15] = rng.integers(0, modulus >> 240, size=tuple(shape))
    return limbs.astype(np.int32)


def jax_of(x):
    return jnp.asarray(np.asarray(x).astype(np.uint32))


def np_of(x):
    return np.asarray(x).astype(np.int64)


def operands(spec, seed):
    """Random limbs plus the edge values 0, 1, p-1, p-2 on both sides."""
    rng = np.random.default_rng(seed)
    a = rand_limbs(rng, spec.modulus, (B,))
    b = rand_limbs(rng, spec.modulus, (B,))
    edges = [0, 1, spec.modulus - 1, spec.modulus - 2]
    a[:, :4] = spec.pack(edges, mont=False)
    b[:, :4] = spec.pack(edges[::-1], mont=False)
    return a, b


@pytest.mark.parametrize("name", ["fq", "fr"])
def test_constants_match_jax_fieldspec(name):
    spec, jspec = (FQ, JF.FQ) if name == "fq" else (FR, JF.FR)
    assert np.array_equal(spec.mod_limbs, np.asarray(jspec.mod_limbs, np.int64))
    assert spec.r_mod == jspec.r_mod and spec.r2 == jspec.r2
    assert spec.n0inv == int(jspec.n0inv)
    assert (spec.n0inv32 * spec.modulus) % (1 << 32) == (1 << 32) - 1
    assert np.array_equal(spec.one_mont_np, np.asarray(jspec.one_mont_np, np.int64))


@pytest.mark.parametrize("name", ["fq", "fr"])
def test_mont_mul_matches_jax_and_oracle(name):
    spec, jspec = (FQ, JF.FQ) if name == "fq" else (FR, JF.FR)
    a, b = operands(spec, 1)
    got = F.mont_mul(spec, torch.as_tensor(a), torch.as_tensor(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np_of(JF.mont_mul(jspec, jax_of(a), jax_of(b))))
    va, vb = limbs_batch_to_ints(a), limbs_batch_to_ints(b)
    assert limbs_batch_to_ints(got.numpy()) == [
        x * y * spec.r_inv % spec.modulus for x, y in zip(va, vb)
    ]


def test_add_sub_neg_match_jax():
    a, b = operands(FQ, 2)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = jax_of(a), jax_of(b)
    assert np.array_equal(F.fq_add(ta, tb).numpy(), np_of(JF.fq_add(ja, jb)))
    assert np.array_equal(F.fq_sub(ta, tb).numpy(), np_of(JF.fq_sub(ja, jb)))
    assert np.array_equal(F.fq_neg(ta).numpy(), np_of(JF.fq_neg(ja)))
    va = limbs_batch_to_ints(a)
    assert limbs_batch_to_ints(F.fq_add(ta, ta).numpy()) == [2 * v % bn.P for v in va]


def test_inverse_matches_jax():
    a, _ = operands(FQ, 3)
    got = F.fq_inv(torch.as_tensor(a))
    assert np.array_equal(got.numpy(), np_of(JF.fq_inv(jax_of(a))))
    assert limbs_batch_to_ints(got.numpy())[0] == 0  # zero maps to zero


def test_broadcast_component_axis_and_select():
    """Ops broadcast over an inserted component axis (tower layout)."""
    a, b = operands(FQ, 4)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    wide = torch.stack([ta, tb], 1)  # (16, 2, B)
    got = F.fq_mul(wide, tb.unsqueeze(1))
    assert torch.equal(got[:, 0], F.fq_mul(ta, tb))
    assert torch.equal(got[:, 1], F.fq_mul(tb, tb))
    cond = torch.arange(B) % 2 == 0
    sel = F.select(cond, ta, tb)
    assert torch.equal(sel[:, ::2], ta[:, ::2]) and torch.equal(sel[:, 1::2], tb[:, 1::2])


def test_k1_wrapper_dispatches_cpu_to_plain_twin():
    a, b = operands(FQ, 5)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    before = FC.mont_mul.launches
    assert torch.equal(FC.mont_mul(FQ, ta, tb), F.mont_mul(FQ, ta, tb))
    assert FC.mont_mul.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError):
        FC.mont_mul(FQ, ta.to("meta"), tb.to("meta"))

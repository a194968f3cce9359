"""The port's CUDA kernels on a card: each kernel against its plain PyTorch
twin on the same CUDA tensors (exact), the batched slice on CUDA and one
single-proof facade call on CUDA. Marked
``gpu``; every test skips where no CUDA device is present. On a machine
with one, run ``python -m pytest --noconftest tests/test_torch_gpu.py -m gpu``
(no JAX needed); chip_smoke.py runs the same checks at the main path's
full size."""

import random

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.fixtures.gen import gen_groth16_vector
from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu_torch import Groth16BatchVerifier, Groth16Verifier
from snark_bn254_verifier_tpu_torch.models.packing import pack_g1, pack_g2, pair_major
from snark_bn254_verifier_tpu_torch.ops import curve as C
from snark_bn254_verifier_tpu_torch.ops import field as F
from snark_bn254_verifier_tpu_torch.ops import lines as LN
from snark_bn254_verifier_tpu_torch.ops import pairing as PR
from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC
from snark_bn254_verifier_tpu_torch.ops.limbs import FQ, FR

pytestmark = pytest.mark.gpu

B = 32


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def on(dev, tup):
    return tuple(torch.as_tensor(np.ascontiguousarray(x), device=dev) for x in tup)


def points(rng, n):
    return [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(n)]


def test_mont_mul_kernel_equals_plain(cuda):
    rng = np.random.default_rng(61)
    for spec in (FQ, FR):
        a = rng.integers(0, 1 << 16, size=(16, 3, B)).astype(np.int32)
        b = rng.integers(0, 1 << 16, size=(16, 3, B)).astype(np.int32)
        a[15] %= spec.modulus >> 240
        b[15] %= spec.modulus >> 240
        ta, tb = on(cuda, (a, b))
        before = PC.mont_mul.launches
        got = PC.mont_mul(spec, ta, tb)
        assert PC.mont_mul.launches == before + 1
        assert torch.equal(got, F.mont_mul(spec, ta, tb))


def test_msm_affine_kernel_equals_plain(cuda):
    rng = random.Random(62)
    pool = points(rng, 4)
    lanes = [[pool[(i + j) % 4] for i in range(B)] for j in range(3)]
    lanes[1][0] = None
    packed = [pack_g1(l) for l in lanes]
    pts = on(cuda, tuple(np.stack([p[i] for p in packed]) for i in range(3)))
    sc = on(cuda, (np.stack([FR.pack([rng.randrange(bn.R) for _ in range(B)], mont=False)
                             for _ in range(3)]),))[0]
    got, want = PC.msm_affine(pts, sc), C.msm_affine(pts, sc)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_msm_affine_kernel_more_points_than_a_group(cuda):
    """9 points (a VK with 8 public inputs): three Straus groups summed."""
    rng = random.Random(64)
    n = 9
    pool = points(rng, 5)
    lanes = [[pool[(i + j) % 5] if (i + j) % 7 else None for i in range(B)] for j in range(n)]
    packed = [pack_g1(l) for l in lanes]
    pts = on(cuda, tuple(np.stack([p[i] for p in packed]) for i in range(3)))
    sc = on(cuda, (np.stack([FR.pack([rng.randrange(bn.R) for _ in range(B)], mont=False)
                             for _ in range(n)]),))[0]
    got, want = PC.msm_affine(pts, sc), C.msm_affine(pts, sc)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_miller_and_final_exp_kernels_equal_plain(cuda):
    rng = random.Random(63)
    q_fixed = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    lines, tails = LN.tables_from_numpy([LN.g2_line_table(q) for q in q_fixed], cuda)
    pool = points(rng, 4)
    fixed = tuple(on(cuda, pack_g1([pool[(i + j) % 4] for i in range(B)])) for j in range(2))
    vq_pool = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    vp = on(cuda, pack_g1([pool[i % 4] if i else None for i in range(B)]))
    vq = on(cuda, pack_g2([vq_pool[i % 2] for i in range(B)]))
    for args in ((vp, vq, fixed), (None, None, fixed)):
        f = PC.miller_mixed(*args, lines, tails)
        assert torch.equal(f, PR.miller_mixed(*args, lines, tails))
    assert torch.equal(PC.final_exp(f), PR.final_exp(f))


def test_slice_on_cuda(cuda):
    vec = gen_groth16_vector(0)
    proofs = [vec.proof] * B
    inputs = [list(vec.public_inputs) for _ in range(B)]
    inputs[3] = [1, 2]
    PC.reset_launch_counts()
    ok = Groth16BatchVerifier(vec.vk, device="cuda").verify_batch(proofs, inputs)
    assert ok.tolist() == [i != 3 for i in range(B)]
    launches = PC.launch_counts()
    assert all(launches[k] > 0 for k in ("mont_mul", "msm_affine", "miller_mixed", "final_exp"))


def test_miller_product_kernel_equals_plain(cuda):
    """K5 for 3 pairs (one shared chain) and 5 (two), with infinite P and
    Q lanes and a pair infinite by its mask alone."""
    rng = random.Random(65)
    g1, g2 = points(rng, 4), [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(3)]
    for n in (3, 5):
        ps = [[g1[(i + j) % 4] if (i + j) % 5 else None for i in range(B)] for j in range(n)]
        qs = [[g2[(i * j) % 3] if (i + 2 * j) % 7 else None for i in range(B)] for j in range(n)]
        p, q = pair_major(pack_g1, ps), pair_major(pack_g2, qs)
        p[2][0, 1] = True  # infinite by the mask, coordinates kept
        P, Q = on(cuda, p), on(cuda, q)
        before = PC.miller_product.launches
        got = PC.miller_product(P, Q)
        assert PC.miller_product.launches == before + 1
        assert torch.equal(got, PR.miller_product(P, Q))


def test_groth16_facade_on_cuda(cuda):
    vec = gen_groth16_vector(0)
    PC.reset_launch_counts()
    assert Groth16Verifier.verify(vec.proof, vec.vk, vec.public_inputs, device="cuda") is True
    launches = PC.launch_counts()
    assert all(launches[k] > 0 for k in ("msm_affine", "miller_product", "final_exp"))

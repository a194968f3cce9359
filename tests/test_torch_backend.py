"""PyTorch port, single-proof backend: TorchBackend("cpu") (the kernels'
plain twins: K2 for MSMs, K5 + K4 for pairings) gives the OracleBackend's
answers, point for point and Fq12 for Fq12, on the primitives the shared
protocol code calls: msm and g1_mul (zero scalars, an infinite point, no
points), pairing, pairing_batch with infinite P and Q, and
pairing_batch_is_one both ways."""

import random

import pytest
import torch

from snark_bn254_verifier_tpu.models.backend import OracleBackend, get_backend
from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu_torch import TorchBackend
from torch_host_build import one_torch_thread  # noqa: F401 (autouse)

ORACLE = OracleBackend()


@pytest.fixture(scope="module")
def backend():
    return TorchBackend("cpu")


@pytest.fixture(scope="module")
def pts():
    rng = random.Random(91)
    g1 = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(3)]
    g2 = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    scalars = [rng.randrange(bn.R) for _ in range(3)]
    return g1, g2, scalars


MSM_CASES = {
    "three points": lambda g1, sc: (g1, sc),
    "zero scalars": lambda g1, sc: (g1[:2], [0, 0]),
    "an infinite point": lambda g1, sc: ([g1[0], None], sc[:2]),
    "no points": lambda g1, sc: ([], []),
}


@pytest.mark.parametrize("case", list(MSM_CASES))
def test_msm_matches_oracle(backend, pts, case):
    g1, _, sc = pts
    points, scalars = MSM_CASES[case](g1, sc)
    assert backend.msm(points, scalars) == ORACLE.msm(points, scalars)


def test_g1_mul_reduces_its_scalar(backend, pts):
    g1, _, _ = pts
    assert backend.g1_mul(g1[1], bn.R + 5) == ORACLE.g1_mul(g1[1], 5)


def test_pairing_matches_oracle(backend, pts):
    g1, g2, _ = pts
    assert backend.pairing(g1[0], g2[0]) == ORACLE.pairing(g1[0], g2[0])


def test_pairing_batch_with_infinite_pairs_matches_oracle(backend, pts):
    g1, g2, _ = pts
    pairs = [(g1[0], g2[0]), (None, g2[1]), (g1[1], None), (g1[2], g2[1])]
    assert backend.pairing_batch(pairs) == ORACLE.pairing_batch(pairs)


@pytest.mark.parametrize("cancels", [True, False], ids=["product_one", "product_not_one"])
def test_pairing_batch_is_one_matches_oracle(backend, pts, cancels):
    g1, g2, _ = pts
    pairs = [(g1[0], g2[0])] + ([(bn.g1_neg(g1[0]), g2[0])] if cancels else [])
    want = ORACLE.pairing_batch_is_one(pairs)
    assert want is cancels
    assert backend.pairing_batch_is_one(pairs) is want


def test_protocol_code_takes_it_as_a_backend(backend):
    assert get_backend(backend) is backend
    assert backend.name == "torch" and backend.device == torch.device("cpu")


def test_cuda_device_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        TorchBackend("cuda")

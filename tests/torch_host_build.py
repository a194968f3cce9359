"""What the port's test files share: the fixture that runs the plain twins
on one torch thread, the host build of the kernels' headers
(csrc/host_check.cc, built by ops/_build.py::load_host_check) in both
forms of the Montgomery product (the ``lib`` and ``lib_rolled``
fixtures), the calls of it that more than one test file makes (g2_lines'
rows and K3 over them, as the wrappers of ops/pairing_cuda.py run them on
the card), and the MSM's edge lanes that K2's and K6's host tests share."""

import shutil

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu_torch.ops import lines as LN


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain twins' tensors are a few lanes wide, too narrow for torch's
    threads; one thread keeps parallel test workers off each other's cores.
    Autouse in every test file that imports it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def host_check(rolled):
    """The host build with the rolled or the unrolled Montgomery product;
    skips the test where no host C++ compiler is installed."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    from snark_bn254_verifier_tpu_torch.ops import _build

    return _build.load_host_check(rolled)


@pytest.fixture(scope="module")
def lib():
    """Built with the unrolled Montgomery product, K1's, K3's and K4's."""
    return host_check(False)


@pytest.fixture(scope="module")
def lib_rolled():
    """Built with the rolled Montgomery product, K2's, K5's and g2_lines'."""
    return host_check(True)


def ptr(t):
    return t.data_ptr()


def c_tensor(x):
    return torch.as_tensor(np.ascontiguousarray(x)).contiguous()


def host_var_rows(lib, var_p, var_q):
    """g2_lines' rows on the host build, on its inputs as
    ops/pairing_cuda.py passes them: lanes where P or Q is at infinity
    zeroed."""
    n = var_p[0].shape[-1]
    skip = var_p[2] | var_q[2]
    px, py = (torch.where(skip, 0, t).contiguous() for t in var_p[:2])
    qx, qy = (torch.where(skip, 0, t).contiguous() for t in var_q[:2])
    rows = torch.empty((LN.VAR_ROWS, 3, 2, 8, n), dtype=torch.int32)
    assert lib.host_g2_lines(ptr(px), ptr(py), ptr(qx), ptr(qy), ptr(rows), n) == 0
    return rows


def host_miller_mixed(lib, var_p, var_q, fixed, lines, tails):
    """K3 on the host build as the wrapper runs it: g2_lines' rows of the
    variable pair (where there is one; the rolled build, g2_lines' form),
    then K3 over them and the fixed pairs, whose infinite lanes are
    zeroed."""
    n = (fixed[0][0] if fixed else var_p[0]).shape[-1]
    rows = host_var_rows(host_check(True), var_p, var_q) if var_p is not None else None
    if fixed:
        fpx = c_tensor(torch.stack([torch.where(inf, 0, x) for x, _, inf in fixed]))
        fpy = c_tensor(torch.stack([torch.where(inf, 0, y) for _, y, inf in fixed]))
    else:
        fpx = fpy = torch.empty((0, 16, n), dtype=torch.int32)
    f = torch.empty((16, 12, n), dtype=torch.int32)
    assert lib.host_miller_mixed(ptr(rows) if rows is not None else None, ptr(fpx), ptr(fpy),
                                 len(fixed), ptr(lines), ptr(tails), ptr(f), n) == 0
    return f


def msm_edge_lanes(rng, n, b):
    """n points over b lanes with random scalars and, where n allows, the
    edge lanes of chip_smoke.py: 0 zero scalars, 1 an infinite point, 2
    scalar r - 1, 3 one point thrice (the sums double), 4 P + (-P)."""
    pool = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(5)]
    lanes = [[pool[(i + j) % 5] for i in range(b)] for j in range(n)]
    scal = [[rng.randrange(bn.R) for _ in range(b)] for _ in range(n)]
    for j in range(n):
        scal[j][0] = 0
    lanes[n - 1][1] = None
    scal[0][2] = bn.R - 1
    for j in range(1, min(n, 3)):
        lanes[j][3], scal[j][3] = lanes[0][3], scal[0][3]
    if n >= 2:
        lanes[1][4], scal[1][4] = bn.g1_neg(lanes[0][4]), scal[0][4]
    return lanes, scal

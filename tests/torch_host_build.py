"""The host build of the kernels' headers (csrc/host_check.cc, built by
ops/_build.py::load_host_check) and the calls of it that more than one
test file makes: g2_lines' rows and K3 over them, as the wrappers of
ops/pairing_cuda.py run them on the card."""

import shutil

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu_torch.ops import lines as LN


def host_check(rolled):
    """The host build with the rolled or the unrolled Montgomery product;
    skips the test where no host C++ compiler is installed."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    from snark_bn254_verifier_tpu_torch.ops import _build

    return _build.load_host_check(rolled)


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

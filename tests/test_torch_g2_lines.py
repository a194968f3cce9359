"""g2_lines, the variable pair's line rows of the Groth16 batch's Miller
product, and K3 over them, built for the host (csrc/host_check.cc, each
thread of a block a fiber; tests/torch_host_build.py)
and held to the plain twins of ops/pairing.py: g2_lines' team against
``var_line_rows``, which records the twin's own tangent and chord lines,
and K3, which runs no G2 step, against ``miller_mixed``. A file of its
own, as each unit's host build, so that test workers share them.
Skips where no host C++ compiler is installed."""

import random

import pytest
import torch

from snark_bn254_verifier_tpu_torch.models.packing import pack_g1, pack_g2
from snark_bn254_verifier_tpu_torch.ops import lines as LN
from snark_bn254_verifier_tpu_torch.ops import pairing as PR
from snark_bn254_verifier_tpu_torch.ops.limbs import FQ
from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn
from torch_host_build import (  # noqa: F401 (one_torch_thread: autouse)
    c_tensor,
    host_miller_mixed,
    host_var_rows,
    lib,
    lib_rolled,
    one_torch_thread,
)


@pytest.mark.parametrize("n", [3, 17])
def test_g2_lines_team_equals_plain_twin(lib_rolled, n):
    """g2_lines' team against ops/pairing.py::var_line_rows, which records
    the plain twin's own tangent and chord lines evaluated at P: every one
    of the VAR_ROWS rows limb-equal, and the line (1, 0, 0) in every row of
    a lane whose P or Q is at infinity. ``n`` lanes in blocks of GL_LPB =
    16: a ragged block alone, or after a full one."""
    rng = random.Random(59)
    g1 = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(3)]
    g2 = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    # lanes: finite; P infinite; Q infinite; finite with the other Q
    vp = [[g1[0], None, g1[1], g1[2]][i % 4] for i in range(n)]
    vq = [[g2[0], g2[1], None, g2[1]][i % 4] for i in range(n)]
    var_p = tuple(c_tensor(a) for a in pack_g1(vp))
    var_q = tuple(c_tensor(a) for a in pack_g2(vq))
    got = host_var_rows(lib_rolled, var_p, var_q)
    assert torch.equal(got, PR.var_line_rows(var_p, var_q))
    one = [(FQ.r_mod >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
    one = torch.tensor([w - (1 << 32) if w >> 31 else w for w in one], dtype=torch.int32)
    for lane in (1, 2):
        off = got[..., lane]
        assert (off[:, 0, 0] == one).all() and not off[:, 0, 1].any() and not off[:, 1:].any()
    assert got[..., 0].ne(0).any(dim=(1, 2, 3)).all()  # a finite lane's rows are lines


@pytest.mark.parametrize("nf", [0, 1, 2])
def test_miller_mixed_prepared_rows_equal_plain_twin(lib, nf):
    """K3's schedule, which runs no G2 step and multiplies f by g2_lines'
    rows, limb-equal to ops/pairing.py::miller_mixed with nf fixed pairs
    beside the variable pair: 9 lanes (a full block of MM_LPB = 8, then a
    ragged one), the variable P at infinity on lane 1, its Q on lane 2 and
    the first fixed P on lane 3."""
    rng = random.Random(60 + nf)
    q_fixed = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(nf)]
    lines, tails = LN.tables_from_numpy([LN.g2_line_table(q) for q in q_fixed]) if nf else (
        torch.zeros((0, 4, LN.STEPS, 16, 2), dtype=torch.int32),
        torch.zeros((0, 2, 2, 16, 2), dtype=torch.int32))
    lines, tails = lines.contiguous(), tails.contiguous()
    g1 = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(4)]
    g2 = bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R))
    n = 9
    vp = [g1[0], None] + [g1[(i + 1) % 4] for i in range(2, n)]
    vq = [g2, g2, None] + [g2] * (n - 3)
    fl = [[g1[(i + j + 1) % 4] for i in range(n)] for j in range(nf)]
    if nf:
        fl[0][3] = None
    var_p = tuple(c_tensor(a) for a in pack_g1(vp))
    var_q = tuple(c_tensor(a) for a in pack_g2(vq))
    fixed = tuple(tuple(c_tensor(a) for a in pack_g1(l)) for l in fl)
    want = PR.miller_mixed(var_p, var_q, fixed, lines, tails)
    assert torch.equal(host_miller_mixed(lib, var_p, var_q, fixed, lines, tails), want)

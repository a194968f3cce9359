"""PyTorch port, line tables: the JAX-free ops/lines.py::g2_line_table
equals the JAX package's ops/lines.py::g2_line_table limb for limb, and
tables_from_numpy turns either into the same tensors."""

import random

import numpy as np
import torch

from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu.ops import lines as JLN
from snark_bn254_verifier_tpu_torch.ops import lines as LN
from torch_host_build import one_torch_thread  # noqa: F401 (autouse)


def test_line_table_equals_jax_limb_for_limb():
    rng = random.Random(21)
    qs = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    ours = [LN.g2_line_table(q) for q in qs]
    ref = [JLN.g2_line_table(q) for q in qs]
    assert LN.MILLER_BITS == JLN.MILLER_BITS and LN.STEPS == JLN.STEPS
    for tb, jtb in zip(ours, ref):
        for field in LN.G2LineTable._fields:
            a, b = getattr(tb, field), getattr(jtb, field)
            assert a.shape == b.shape, field
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), field
    lines, tails = LN.tables_from_numpy(ours)
    jlines, jtails = LN.tables_from_numpy(ref)
    assert lines.dtype == torch.int32
    assert lines.shape == (2, 4, LN.STEPS, 16, 2) and tails.shape == (2, 2, 2, 16, 2)
    assert torch.equal(lines, jlines) and torch.equal(tails, jtails)
    # add rows are zero exactly where the schedule bit is 0
    for i, bit in enumerate(LN.MILLER_BITS):
        assert bool(lines[:, 2:, i].any()) == bool(bit)

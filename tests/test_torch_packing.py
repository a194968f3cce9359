"""PyTorch port, the host packers: the byte-path packers and unpackers of
ops/limbs.py and models/packing.py (and the native Montgomery packer where
the host library loads) equal the per-limb path they replaced, built here
from ``int_to_limbs`` (kept as the reference), on random values and on
the edges."""

import random

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu_torch.models import packing as PK
from snark_bn254_verifier_tpu_torch.ops.limbs import (
    FQ,
    FR,
    int_to_limbs,
    ints_to_limbs_batch,
    limbs_batch_to_ints,
)
from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn
from snark_bn254_verifier_tpu_torch.utils import native

EDGES = [0, 1, 2, bn.P - 1, bn.R - 1, bn.R, bn.P, (1 << 256) - 1, 1 << 255]


def old_limbs(values):
    """The per-limb path: 16 Python shifts per value."""
    return np.stack([int_to_limbs(v) for v in values], axis=1)


def old_pack(spec, values, mont=True):
    return old_limbs([spec.to_mont_int(v) if mont else v % spec.modulus for v in values])


def old_ints(limbs):
    flat = np.asarray(limbs, dtype=np.int64).reshape(16, -1)
    return [sum(int(flat[i, j]) << (16 * i) for i in range(16)) for j in range(flat.shape[1])]


def rand_values(seed, n, below=1 << 256):
    rng = random.Random(seed)
    return [rng.randrange(below) for _ in range(n)]


@pytest.mark.parametrize("values", [EDGES, rand_values(1, 300)], ids=["edges", "random"])
def test_ints_to_limbs_batch_equals_int_to_limbs(values):
    got = ints_to_limbs_batch(values)
    assert got.dtype == np.int32 and got.shape == (16, len(values))
    assert np.array_equal(got, old_limbs(values))
    assert limbs_batch_to_ints(got) == old_ints(got) == values


@pytest.mark.parametrize("bad", [-1, 1 << 256])
def test_out_of_range_raises(bad):
    with pytest.raises(ValueError):
        ints_to_limbs_batch([1, bad])
    with pytest.raises(ValueError):
        int_to_limbs(bad)


def test_empty_batch():
    assert ints_to_limbs_batch([]).shape == (16, 0)
    assert limbs_batch_to_ints(np.zeros((16, 0), np.int32)) == []
    for spec in (FQ, FR):
        assert spec.pack([]).shape == (16, 0) and spec.unpack(np.zeros((16, 0))) == []
    assert PK.pack_fq([]).shape == (16, 0)
    x, y, inf = PK.pack_g1([])
    assert x.shape == y.shape == (16, 0) and inf.shape == (0,)


def test_limbs_batch_to_ints_batch_axes_and_wide_limbs():
    """Batch axes come back flat in C order; a limb outside 16 bits (which
    no path of the port makes) raises rather than wrapping silently."""
    limbs = np.random.default_rng(3).integers(0, 1 << 16, size=(16, 3, 5)).astype(np.int32)
    assert limbs_batch_to_ints(limbs) == old_ints(limbs)
    for at, bad in (((0, 0), 1 << 16), ((3, 2), -1)):
        wide = limbs.reshape(16, -1).astype(np.int64)
        wide[at] = bad
        with pytest.raises(ValueError, match="16 bits"):
            limbs_batch_to_ints(wide)


@pytest.mark.parametrize("spec", [FQ, FR], ids=["fq", "fr"])
@pytest.mark.parametrize("mont", [True, False], ids=["mont", "canonical"])
def test_field_pack_unpack_equal_per_limb_path(spec, mont):
    """Values at and above the modulus, and negative ones, are reduced as
    before; public inputs >= r come out reduced."""
    values = EDGES + [-1, -bn.P, 3 * spec.modulus + 5, 1 << 300] + rand_values(4, 200)
    got = spec.pack(values, mont=mont)
    assert got.dtype == np.int32
    assert np.array_equal(got, old_pack(spec, values, mont))
    back = spec.unpack(got, mont=mont)
    assert back == [v % spec.modulus for v in values]
    assert back == [spec.from_mont_int(v) if mont else v for v in old_ints(got)]


def test_public_inputs_at_or_above_r_are_reduced():
    got = PK.pack_fr_canonical([bn.R, bn.R + 5, 2 * bn.R - 1])
    assert np.array_equal(got, old_limbs([0, 5, bn.R - 1]))


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "bytes"])
def test_pack_fq_equals_per_limb_path(use_native, monkeypatch):
    """pack_fq by either packer, and packer() names the one that ran."""
    if use_native and not native.native_available():
        pytest.skip("the native host library did not build")
    if not use_native:
        monkeypatch.setattr(native, "native_available", lambda: False)
    values = EDGES + [-5, 1 << 300] + rand_values(5, 500, bn.P)
    got = PK.pack_fq(values)
    assert got.dtype == np.int32 and np.array_equal(got, old_pack(FQ, values))
    assert PK.packer() == ("native" if use_native else "bytes")
    assert PK.unpack_fq(got) == [v % bn.P for v in values]


def test_native_pack_be_batch_equals_per_limb_path():
    if not native.native_available():
        pytest.skip("the native host library did not build")
    values = EDGES + rand_values(6, 100)
    buf = b"".join(v.to_bytes(32, "big") for v in values)
    limbs, flags = native.pack_be_batch(buf, len(values))
    assert np.array_equal(limbs.astype(np.int32), old_pack(FQ, values))
    assert flags.tolist() == [int(v >= bn.P) for v in values]


def rand_points(seed, n):
    rng = random.Random(seed)
    pts = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(n)]
    pts[1] = None
    return pts


def test_pack_and_unpack_g1_equal_per_coordinate_path():
    pts = rand_points(7, 6)
    x, y, inf = PK.pack_g1(pts)
    assert np.array_equal(x, old_pack(FQ, [p[0] if p else 0 for p in pts]))
    assert np.array_equal(y, old_pack(FQ, [p[1] if p else 0 for p in pts]))
    assert inf.tolist() == [p is None for p in pts]
    assert x.flags.c_contiguous and y.flags.c_contiguous
    tx, ty, tinf = (torch.as_tensor(a) for a in (x, y, inf))
    assert PK.unpack_g1(tx, ty, tinf) == pts


def test_pack_g2_equals_per_coordinate_path():
    rng = random.Random(8)
    pts = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(4)] + [None]
    x, y, inf = PK.pack_g2(pts)
    for arr, i in ((x, 0), (y, 1)):
        assert arr.shape == (16, 2, 5)
        for c in range(2):
            assert np.array_equal(arr[:, c], old_pack(FQ, [p[i][c] if p else 0 for p in pts]))
    assert inf.tolist() == [False] * 4 + [True]


def test_pack_and_unpack_fq12_equal_per_component_path():
    rng = random.Random(9)
    vals = [bn.FQ12_ONE, bn.pairing(bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)), bn.G2_GEN)]
    got = PK.pack_fq12(vals)
    assert got.shape == (16, 12, 2)
    for h in range(2):
        for j in range(3):
            for c in range(2):
                assert np.array_equal(got[:, 6 * h + 2 * j + c],
                                      old_pack(FQ, [v[h][j][c] for v in vals]))
    assert PK.unpack_fq12(got) == vals


def test_pack_columns_equals_per_column_packing():
    """The batch verifiers' scalar columns (models/packing.py::
    pack_fr_columns): lane k's list as column k, each value mod r, dead
    lanes (None) all zero, in one packer call, contiguous."""
    rng = random.Random(10)
    cols = [[rng.randrange(bn.R) for _ in range(4)], None, [1, 0, bn.R - 1, 2],
            [bn.R, bn.R + 3, -1, 2 * bn.R - 1]]
    got = PK.pack_fr_columns(cols, 4, 4)
    assert got.shape == (4, 16, 4) and got.flags["C_CONTIGUOUS"]
    for j in range(4):
        assert np.array_equal(got[j], old_limbs([c[j] % bn.R if c else 0 for c in cols]))

"""The port's roofline accounting (snark_bn254_verifier_tpu_torch/utils/
roofline.py) against the JAX package's (utils/roofline.py): the leaf costs
counted on the port's plain twins equal the JAX ones counted on its XLA
ops, key for key; the per-proof totals equal the JAX functions' (50,866 a
Groth16 proof with 2 inputs); the bench-line fields follow from the H100
model, with the card's share read from what a lane computes (37,987); chip_smoke.py takes its card model from the module, and the kernel
bounds read the kernel table's work (PERF.md) as they did in chip_smoke."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.utils import roofline as JR
from snark_bn254_verifier_tpu_torch.utils import roofline as PR

REPO = Path(__file__).resolve().parents[1]
LEAVES = ("miller_step", "miller_tail", "var_dbl_line", "var_add_line", "fixed_line",
          "fe_easy", "fq12_mul", "fq12_sq", "fq12_cyc_sq", "frobenius", "jac_double",
          "jac_add_mixed", "jac_add_full", "to_affine")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The twins' B = 1 tensors are too narrow for torch's threads; one
    thread keeps parallel test workers off each other's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_leaf_keys_equal():
    assert set(PR._leaf_costs()) == set(JR._leaf_costs()) == set(LEAVES)


@pytest.mark.parametrize("leaf", LEAVES)
def test_leaf_cost_equals_jax(leaf):
    """Every leaf is counted by the JAX module's definition on the port's
    twins; ``fe_easy`` keeps the JAX module's three Straus-base Frobenius
    maps and the curve additions add a point to itself (the doubling
    fallback the JAX select pays), so no leaf needs its own number."""
    assert PR._leaf_costs()[leaf] == JR._leaf_costs()[leaf]


@pytest.mark.parametrize("fn,arg,want", [
    ("groth16_mults_per_proof", 2, 50_866),
    ("plonk_mults_per_proof", 0, 83_476),
    ("plonk_mults_per_proof", 1, 86_924),
])
def test_per_proof_totals_equal_jax(fn, arg, want):
    assert getattr(PR, fn)(arg) == getattr(JR, fn)(arg) == want


@pytest.mark.parametrize("fn,args", [
    ("miller_loop_mults", ()), ("final_exp_mults", ()), ("pairing_product_mults", (3,)),
    ("mixed_product_mults", (2, True)), ("mixed_product_mults", (2, False)),
    ("straus_msm_mults", (3,)), ("windowed_msm_mults", (11,)),
])
def test_composite_counts_equal_jax(fn, args):
    assert getattr(PR, fn)(*args) == getattr(JR, fn)(*args)


def test_roofline_fields_on_a_fixed_rate():
    """60,000 proofs/s of 50,866 products: 3.05196e9 products/s, each 264
    multiply-adds, against 64 x 132 x 1.98e9 = 1.672704e13 /s: 4.82%."""
    got = PR.roofline_fields(60_000.0, 50_866)
    assert got == {"mults_per_proof": 50_866, "mont_mults_per_sec": 3_051_960_000.0,
                   "pct_imad_roofline": 4.82}
    assert PR.IMAD_PER_S == 64 * 132 * 1.98e9 and PR.IMAD_PER_FP_MUL == 264
    assert PR.roofline_fields(0.0, 50_866)["pct_imad_roofline"] == 0.0


def test_roofline_fields_with_the_computed_count():
    """The card's share reads what a lane computes: 60,000 proofs/s of
    37,987 products is 2.27922e9 products/s, 3.6% of the peak, beside the
    JAX-counted 4.82% of the same rate."""
    got = PR.roofline_fields(60_000.0, 50_866, 37_987)
    assert got["pct_imad_roofline"] == 4.82
    assert got["computed_mults_per_proof"] == 37_987
    assert got["pct_imad_roofline_computed"] == 3.6


def test_lane_mults_of_the_bench_groth16_proof():
    """One lane of the bench's Groth16 proof computes 37,987 products on
    the twins: K2 5,638 (the table's 5,610 is chip_smoke's lanes' scalars),
    K3 20,994, K4 11,348 and the G2 mask's 7; fewer than the 50,866 that
    count both branches."""
    from snark_bn254_verifier_tpu_torch.fixtures.gen import gen_groth16_vector
    from snark_bn254_verifier_tpu_torch.parallel.batch import Groth16BatchVerifier

    vec = gen_groth16_vector(0, num_inputs=2)
    got = PR.lane_mults(Groth16BatchVerifier, vec.vk, vec.proof, vec.public_inputs)
    assert got == 5_638 + 20_994 + 11_348 + 7 == 37_987


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_uses_the_module_model():
    smoke = _load_chip_smoke()
    assert smoke.bound is PR.bound and smoke.count_fp_muls is PR.count_fp_muls
    assert smoke.pippenger_work is PR.pippenger_work
    assert not hasattr(smoke, "IMAD_PER_S") and not hasattr(smoke, "HBM_BYTES_PER_S")


@pytest.mark.parametrize("fp_muls,nbytes,bound_ms,by", [
    (3_072, 589_824, 0.000176, "bytes"),           # K1 mont_mul: bytes set it
    (7 * 1024, 0, 0.000113, "operations"),         # K1 g2_on_curve at batch 1024
    (11_348 * 1024, 0, 0.1834, "operations"),      # K4 at batch 1024
    (22_523_012, 12_648_577, 0.3555, "operations"),  # K6 at 2^16 points
])
def test_bound_reads_the_kernel_table(fp_muls, nbytes, bound_ms, by):
    got = PR.bound(fp_muls, nbytes)
    assert got["bound_ms"] == pytest.approx(bound_ms, rel=5e-3) and got["bound_by"] == by
    assert got["imads"] == 264 * fp_muls and got["bytes"] == nbytes


def test_pippenger_work_equals_a_hand_count():
    """K6's bound counts the bucket method's products on its inputs: at
    c = 8 (32 windows), two lanes of four points. Lane 0: scalars 1, 257,
    0 and 5, the last point at infinity, so 1 + 2 nonzero digits; lane 1:
    scalars 0, 0, 0 and 2^16 + 3, 2 nonzero digits. Each nonzero digit a
    mixed add (madd-2007-bl, 11 products); each lane the running sums (2
    full adds a bucket and window, add-2007-bl, 16 products), Horner (31
    windows of 8 doublings, dbl-2009-l, 7 products, and an add) and one
    affine conversion (a Fermat inverse and 3 products on the twin, 368)."""
    from snark_bn254_verifier_tpu_torch.models.packing import pack_msm
    from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn

    pts = [bn.g1_mul(bn.G1_GEN, k) for k in (1, 2, 3, 4)]
    (x0, y0, inf0), sc0 = pack_msm(pts, [1, 257, 0, 5])
    (x1, y1, inf1), sc1 = pack_msm(pts, [0, 0, 0, (1 << 16) + 3])
    inf0 = inf0.copy()
    inf0[3] = True
    points = (torch.as_tensor(np.concatenate([x0, x1], -1)),
              torch.as_tensor(np.concatenate([y0, y1], -1)),
              torch.as_tensor(np.concatenate([inf0, inf1], -1)))
    scalars = torch.as_tensor(np.concatenate([sc0, sc1], -1))
    per_lane = 32 * 2 * 255 * 16 + 31 * (8 * 7 + 16) + 368
    assert PR.pippenger_work(points, scalars, 8) == 5 * 11 + 2 * per_lane


def test_count_fp_muls_of_a_mask_lane_and_a_final_exp():
    """The twins' per-lane work behind the kernel table's bounds: the G2
    mask 7 products a lane, the final exponentiation 11,348."""
    from snark_bn254_verifier_tpu_torch.fixtures.g2_lanes import g2_mask_lanes
    from snark_bn254_verifier_tpu_torch.ops import curve as C
    from snark_bn254_verifier_tpu_torch.ops import pairing as P
    from snark_bn254_verifier_tpu_torch.ops.limbs import FQ

    x, y, inf, valid, _ = g2_mask_lanes(0, 1, head=("on",))
    bs = tuple(torch.as_tensor(a) for a in (x, y, inf))
    assert PR.count_fp_muls(lambda: C.g2_on_curve(bs, torch.as_tensor(valid))) == 7
    f = torch.as_tensor(np.stack([FQ.pack([3 + i]) for i in range(12)], 1))  # (16, 12, 1)
    assert PR.count_fp_muls(lambda: P.final_exp(f)) == 11_348


def test_count_leaves_pow_const_as_it_was():
    from snark_bn254_verifier_tpu_torch.ops import field as F

    real = F.pow_const
    PR._count(lambda: None)
    PR.count_fp_muls(lambda: None)
    assert F.pow_const is real

"""The port's roofline accounting (snark_bn254_verifier_tpu_torch/utils/
roofline.py) against the JAX package's (utils/roofline.py): the leaf costs
counted on the port's plain twins equal the JAX ones counted on its XLA
ops, key for key; the per-proof totals equal the JAX functions' (50,866 a
Groth16 proof with 2 inputs); the bench-line fields follow from the H100
model, with the card's share read from what a lane computes (34,013);
chip_smoke.py takes its card model from the module, and the kernel
bounds read the kernel table's work (PERF.md) as they did in chip_smoke."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu.utils import roofline as JR
from snark_bn254_verifier_tpu_torch.ops.limbs import FR
from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn
from snark_bn254_verifier_tpu_torch.utils import roofline as PR
from torch_host_build import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
LEAVES = ("miller_step", "miller_tail", "var_dbl_line", "var_add_line", "fixed_line",
          "fe_easy", "fq12_mul", "fq12_sq", "fq12_cyc_sq", "frobenius", "jac_double",
          "jac_add_mixed", "jac_add_full", "to_affine")


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
    """One lane of the bench's Groth16 proof computes 34,013 products on
    the twins: the fixed-base MSM 1,664 (96 mixed adds of 11 products, the
    3 points' 32 windows over the team's 16 threads; 15 adds of 16 in the
    threads' tree; the affine form), K3 20,994, K4 11,348 and the G2
    mask's 7; fewer than the 50,866 that count both branches and K2's
    windowed chain. The window table is the verifier's set-up, not
    counted."""
    from snark_bn254_verifier_tpu_torch.fixtures.gen import gen_groth16_vector
    from snark_bn254_verifier_tpu_torch.parallel.batch import Groth16BatchVerifier

    vec = gen_groth16_vector(0, num_inputs=2)
    got = PR.lane_mults(Groth16BatchVerifier, vec.vk, vec.proof, vec.public_inputs)
    assert got == 1_664 + 20_994 + 11_348 + 7 == 34_013


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_uses_the_module_model():
    smoke = _load_chip_smoke()
    assert smoke.bound is PR.bound and smoke.count_fp_muls is PR.count_fp_muls
    assert smoke.lane_pass_work is PR.lane_pass_work
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


FIXED_HAND_LANES = {
    # lane 0: 0x11, 0x101, 0 and 5: 1 + 2 + 0 digits; lane 1: 0, 0,
    # 2^16 + 3 and 7: 2 digits (3 and 1)
    "two_lanes": ([[0x11, 0], [0x101, 0], [0, (1 << 16) + 3], [5, 7]], 1 + 2 + 2),
    # r - 1 on point 0 (0x30644e...f0000000: 29 nonzero bytes, its low
    # three zero), 2^248 on point 1 (the top window's digit 1), 0x80 on
    # point 2
    "top_window": ([[bn.R - 1], [1 << 248], [0x80], [1]], 29 + 1 + 1),
}


@pytest.mark.parametrize("case", FIXED_HAND_LANES)
def test_fixed_msm_work_equals_a_hand_count(case):
    """The fixed-base MSM's bound counts a mixed add (11 products) per
    nonzero 8-bit digit of a finite point and one affine conversion (368)
    a lane: four points, the last at infinity, whose scalars count
    nothing."""
    rows, digits = FIXED_HAND_LANES[case]
    scalars = torch.as_tensor(np.stack([FR.pack(row, mont=False) for row in rows]))
    inf = torch.tensor([False, False, False, True])
    assert PR.fixed_msm_work(inf, scalars) == digits * 11 + len(rows[0]) * 368


def test_fixed_msm_bytes_count_each_picked_entry_once():
    """Bytes of the fixed-base MSM: 64 for each table entry some lane's
    digit picks, read once however many lanes pick it; none for digit 0
    or a point at infinity; the scalars' int32 limbs and the outputs (129
    bytes a lane). Three lanes over points 0 and 1 (point 2 at infinity):
    lanes 0 and 1 pick the same two entries (digit 3 of window 0 of point
    0, digit 1 of window 1 of point 1), lane 2 one more (digit 3 of
    window 0 of point 1)."""
    rows = [[3, 3, 0], [1 << 8, 1 << 8, 3], [9, 9, 9]]
    scalars = torch.as_tensor(np.stack([FR.pack(row, mont=False) for row in rows]))
    inf = torch.tensor([False, False, True])
    assert PR.fixed_msm_bytes(inf, scalars) == 3 * 64 + 3 * 16 * 3 * 4 + 3 * 129


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


def test_bound_puts_sha256_on_the_alu_pipe():
    """K7's bound: 1,384 ALU instructions a SHA-256 compression (64 rounds
    of 14, 48 schedule words of 10, 8 adds) on the ALU pipe beside the
    products' 264 multiply-adds a product on theirs, each at 64 a clock
    per SM: the busier pipe sets it; the bytes as before."""
    assert PR.SHA256_ALU_PER_COMPRESSION == 1_384
    assert PR.ALU_PER_S == PR.IMAD_PER_S
    got = PR.bound(504 * 1024, 1024 * 1_200, sha256_compressions=17 * 1024)  # K7a's mix
    assert got["bound_ms"] == pytest.approx(504 * 1024 * 264 / PR.IMAD_PER_S * 1e3, rel=1e-12)
    assert got["bound_by"] == "operations" and got["alu_ops"] == 17 * 1024 * 1_384
    assert got["sha256_compressions"] == 17 * 1024 and got["imads"] == 504 * 1024 * 264
    got = PR.bound(36 * 1024, 1024 * 1_200, sha256_compressions=12 * 1024)  # K7b's
    assert got["bound_ms"] == pytest.approx(12 * 1024 * 1_384 / PR.ALU_PER_S * 1e3, rel=1e-12)
    assert "alu_ops" not in PR.bound(7, 0)
    assert PR.bound(0, 3_350, sha256_compressions=1)["bound_by"] == "bytes"


@pytest.fixture(scope="module")
def plonk_lane():
    """One lane of the bench's PlonK vector through K7a's twin: (args of
    K7a, its outputs, the LanesVk)."""
    from snark_bn254_verifier_tpu_torch.fixtures.gen import gen_plonk_vector
    from snark_bn254_verifier_tpu_torch.models.packing import pack_fr_columns
    from snark_bn254_verifier_tpu_torch.ops import plonk_lanes as PL
    from snark_bn254_verifier_tpu_torch.utils import serialization as ser

    vec = gen_plonk_vector(0)
    lvk = PL.LanesVk(ser.load_plonk_verifying_key_from_bytes(vec.vk))
    raw, valid = PL.pack_proofs([vec.proof], lvk)
    pub = pack_fr_columns([vec.public_inputs], lvk.nb_pub, 1)
    args = (torch.as_tensor(raw), torch.as_tensor(pub), torch.as_tensor(valid), lvk)
    return vec, args, PL.plonk_lanes_a_plain(*args)


def test_k7_work_of_the_bench_plonk_lane(plonk_lane):
    """A lane of K7a: 504 products (50 for the proof's ten on-curve checks,
    381 for the one Fermat inversion) and 17 compressions (gamma 5 past
    the VK's midstate, beta 1, alpha 3, zeta 4, BSB22's hash 4); K7b: 36
    products and the fold's 12 compressions."""
    from snark_bn254_verifier_tpu_torch.models.packing import pack_fr_columns
    from snark_bn254_verifier_tpu_torch.ops import plonk_lanes as PL

    vec, args, (ok, zeta, (px, py, _), _) = plonk_lane
    assert ok.tolist() == [True]
    assert PR.count_fp_muls(lambda: PL.plonk_lanes_a_plain(*args)) == 504
    assert PR.count_sha256(lambda: PL.plonk_lanes_a_plain(*args)) == 17
    digest = (px[0], py[0], torch.zeros(1, dtype=torch.bool))
    rand = torch.as_tensor(pack_fr_columns([[5]], 1, 1)[0])

    def fold():
        return PL.plonk_lanes_b_plain(args[0], ok, zeta, rand, digest, args[3])

    real = PL.sha256_compress
    assert PR.count_fp_muls(fold) == 36 and PR.count_sha256(fold) == 12
    assert PL.sha256_compress is real


def test_lane_pass_work_charges_the_divsteps_inverse(plonk_lane):
    """K7's bound counts the work the kernel needs: K7a's twin's 504
    products less the 381 of its Fermat inversion (254 squarings, 127
    multiplies), so 123, its 17 compressions and one inversion at the
    divsteps' cost (600 steps of 21 ALU instructions; 20 matrix
    applications of 90 wide products and 2 low ones, and the product by
    R^3). That is the cheaper way: it charges its pipes less than
    Fermat's chain charges the multiply-adds. K7b inverts nothing. At 1024
    lanes K7a's bound is 0.002227 ms, set by the multiply-adds."""
    from snark_bn254_verifier_tpu_torch.models.packing import pack_fr_columns
    from snark_bn254_verifier_tpu_torch.ops import field as F
    from snark_bn254_verifier_tpu_torch.ops import plonk_lanes as PL

    vec, args, (ok, zeta, (px, py, _), _) = plonk_lane
    real_inv = F.inv
    work = PR.lane_pass_work(lambda: PL.plonk_lanes_a_plain(*args))
    assert F.inv is real_inv
    assert work == {"fp_muls": 123, "sha256_compressions": 17, "fr_inversions": 1}
    assert PR.FR_INV_ALU == 600 * 21 == 12_600
    assert PR.FR_INV_IMADS == 20 * (2 * 90 + 2) + 264 == 3_904
    assert max(PR.FR_INV_IMADS, PR.FR_INV_ALU) < 381 * PR.IMAD_PER_FP_MUL
    got = PR.bound(123 * 1024, 0, sha256_compressions=17 * 1024, fr_inversions=1024)
    assert got["imads"] == 1024 * (123 * 264 + 3_904)
    assert got["alu_ops"] == 1024 * (17 * 1_384 + 12_600) and got["fr_inversions"] == 1024
    assert got["bound_ms"] == pytest.approx(1024 * 36_376 / PR.IMAD_PER_S * 1e3, rel=1e-12)
    assert got["bound_ms"] == pytest.approx(0.002227, rel=1e-3)
    digest = (px[0], py[0], torch.zeros(1, dtype=torch.bool))
    rand = torch.as_tensor(pack_fr_columns([[5]], 1, 1)[0])
    fold = PR.lane_pass_work(lambda: PL.plonk_lanes_b_plain(args[0], ok, zeta, rand, digest,
                                                           args[3]))
    assert fold == {"fp_muls": 36, "sha256_compressions": 12, "fr_inversions": 0}
    assert "fr_inversions" not in PR.bound(36, 0, sha256_compressions=12)


def test_lane_mults_of_the_bench_plonk_proof(plonk_lane, monkeypatch):
    """One lane of the bench's PlonK proof, its randomiser fixed at
    2^200 + 17 (K2 skips zero windows, so the count moves with it): 58,070
    products on the twins: 57,530 of K2, K3 and K4, and K7's 540 (the
    lane pass that the card now runs)."""
    from snark_bn254_verifier_tpu_torch.parallel import batch

    vec = plonk_lane[0]
    monkeypatch.setattr(batch.secrets, "randbelow", lambda n: (1 << 200) + 16)
    got = PR.lane_mults(batch.PlonkBatchVerifier, vec.vk, vec.proof, vec.public_inputs)
    assert got == 57_530 + 504 + 36 == 58_070

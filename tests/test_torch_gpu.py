"""The port's CUDA kernels on a card: each kernel against its plain PyTorch
twin on the same CUDA tensors (exact), the batched slice on CUDA (also
pipelined through verify_batch_async, and at 2048 lanes with every
fault kind), the large MSM through
TorchBackend.msm and one single-proof facade call on CUDA. Marked
``gpu``; every test skips where no CUDA device is present. On a machine
with one, run ``python -m pytest --noconftest tests/test_torch_gpu.py -m gpu``
(no JAX needed); chip_smoke.py runs the same checks at the main path's
full size."""

import random

import numpy as np
import pytest
import torch

from snark_bn254_verifier_tpu_torch import (Groth16BatchVerifier, Groth16Verifier,
                                            PlonkBatchVerifier, TorchBackend)
from snark_bn254_verifier_tpu_torch.fixtures.g2_lanes import g2_mask_lanes
from snark_bn254_verifier_tpu_torch.fixtures.gen import gen_groth16_vector
from snark_bn254_verifier_tpu_torch.fixtures.plonk_lanes import KINDS, plonk_batch_lanes
from snark_bn254_verifier_tpu_torch.models.packing import pack_g1, pack_g2, pair_major
from snark_bn254_verifier_tpu_torch.ops import curve as C
from snark_bn254_verifier_tpu_torch.ops import field as F
from snark_bn254_verifier_tpu_torch.ops import lines as LN
from snark_bn254_verifier_tpu_torch.ops import msm as M
from snark_bn254_verifier_tpu_torch.ops import pairing as PR
from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC
from snark_bn254_verifier_tpu_torch.ops.limbs import FQ, FR
from snark_bn254_verifier_tpu_torch.oracle import bn254 as bn

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


@pytest.mark.parametrize("b", [1024, 1, 33])
def test_g2_on_curve_kernel_equals_plain(cuda, b):
    """The fused K1 at the slice's batch and at ragged sizes, about half
    the lanes divergent (fixtures/g2_lanes.py: y off the curve, infinity,
    by its flag alone over off-curve coordinates too, valid False, random
    coordinates); one launch, exact against the plain twin and the oracle."""
    x, y, inf, valid, want = g2_mask_lanes(68 + b, b)
    bs, valid = on(cuda, (x, y, inf)), torch.as_tensor(valid, device=cuda)
    before = PC.g2_on_curve.launches
    got = PC.g2_on_curve(bs, valid)
    assert PC.g2_on_curve.launches == before + 1
    assert torch.equal(got.cpu(), PC.g2_on_curve(tuple(t.cpu() for t in bs), valid.cpu()))
    assert got.cpu().tolist() == want


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
    """9 points (a VK with 8 public inputs): nine threads' sums combined."""
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


def edge_msm_lanes(rng, n, b):
    """n points over b lanes from a pool with random scalars; from 8 lanes
    on, the edge lanes: 0 zero scalars, 1 an infinite point, 2 scalar
    r - 1, 3 one point thrice, 4 P + (-P)."""
    pool = points(rng, 5)
    lanes = [[pool[(i + j) % 5] for i in range(b)] for j in range(n)]
    scal = [[rng.randrange(bn.R) for _ in range(b)] for _ in range(n)]
    if b >= 8:
        for j in range(n):
            scal[j][0] = 0
        lanes[n - 1][1] = None
        scal[0][2] = bn.R - 1
        for j in range(1, min(n, 3)):
            lanes[j][3], scal[j][3] = lanes[0][3], scal[0][3]
        if n >= 2:
            lanes[1][4], scal[1][4] = bn.g1_neg(lanes[0][4]), scal[0][4]
    return lanes, scal


@pytest.mark.parametrize("n,b", [(3, B + 1), (11, 1), (17, 3)])
def test_msm_affine_team_ragged_and_one_lane(cuda, n, b):
    """K2 (2 lanes per block) at an odd batch, at batch one (PlonK's
    largest MSM) and on 17 points (two passes of the 16-thread team),
    exact against the plain twin on the same inputs (run on the CPU, where
    it is quicker at these sizes)."""
    lanes, scal = edge_msm_lanes(random.Random(66), n, b)
    packed = [pack_g1(l) for l in lanes]
    pts = on(cuda, tuple(np.stack([p[i] for p in packed]) for i in range(3)))
    sc = on(cuda, (np.stack([FR.pack(s, mont=False) for s in scal]),))[0]
    before = PC.msm_affine.launches
    got = PC.msm_affine(pts, sc)
    assert PC.msm_affine.launches == before + 1
    want = C.msm_affine(tuple(t.cpu() for t in pts), sc.cpu())
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.parametrize("n,b", [(3, B + 3), (2, 1), (3, 1), (5, 1)])
def test_miller_product_team_ragged_and_one_lane(cuda, n, b):
    """K5 (one lane of four chains per block) at B + 3 lanes and at batch
    one, with an infinite P and an infinite Q where the batch has room,
    exact against the plain twin on the same inputs (run on the CPU)."""
    rng = random.Random(67)
    g1, g2 = points(rng, 4), [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(3)]
    ps = [[g1[(i + j) % 4] for i in range(b)] for j in range(n)]
    qs = [[g2[(i + 2 * j) % 3] for i in range(b)] for j in range(n)]
    if b > 2:
        ps[0][1] = None
        qs[n - 1][2] = None
    P, Q = on(cuda, pair_major(pack_g1, ps)), on(cuda, pair_major(pack_g2, qs))
    got = PC.miller_product(P, Q)
    want = PR.miller_product(tuple(t.cpu() for t in P), tuple(t.cpu() for t in Q))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("b", [B, B + 3])
def test_miller_and_final_exp_kernels_equal_plain(cuda, b):
    """K3 (8 lanes per block) and K4 (8): at B + 3 lanes the last block of
    each is ragged."""
    rng = random.Random(63)
    q_fixed = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    lines, tails = LN.tables_from_numpy([LN.g2_line_table(q) for q in q_fixed], cuda)
    pool = points(rng, 4)
    fixed = tuple(on(cuda, pack_g1([pool[(i + j) % 4] for i in range(b)])) for j in range(2))
    vq_pool = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    vp = on(cuda, pack_g1([pool[i % 4] if i else None for i in range(b)]))
    vq = on(cuda, pack_g2([vq_pool[i % 2] for i in range(b)]))
    for args in ((vp, vq, fixed), (None, None, fixed)):
        f = PC.miller_mixed(*args, lines, tails)
        assert torch.equal(f, PR.miller_mixed(*args, lines, tails))
    assert torch.equal(PC.final_exp(f), PR.final_exp(f))


@pytest.mark.parametrize("b", [2048, 33, 1])
def test_miller_mixed_with_variable_pair_equals_plain(cuda, b):
    """The Groth16 batch's K3 call: g2_lines prepares the variable pair's
    rows, then K3 multiplies them (one launch each), exact against the
    plain twins (run on the card), at the batch cell's 2048 lanes, a
    ragged 33 and one lane; P at infinity on lane 0 and Q on lane 1 where
    there are two; the rows in a buffer longer than they need."""
    rng = random.Random(68)
    q_fixed = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    lines, tails = LN.tables_from_numpy([LN.g2_line_table(q) for q in q_fixed], cuda)
    pool = points(rng, 4)
    q_pool = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    fixed = tuple(on(cuda, pack_g1([pool[(i + j) % 4] for i in range(b)])) for j in range(2))
    vp = on(cuda, pack_g1([pool[(i + 2) % 4] if i or b == 1 else None for i in range(b)]))
    vq = on(cuda, pack_g2([q_pool[i % 2] if i != 1 else None for i in range(b)]))
    rows = torch.empty(PC.line_rows_words(b) + 5, dtype=torch.int32, device=cuda)
    PC.reset_launch_counts()
    f = PC.miller_mixed(vp, vq, fixed, lines, tails, rows=rows)
    launches = PC.launch_counts()
    assert launches["g2_lines"] == 1 and launches["miller_mixed"] == 1
    assert torch.equal(f, PR.miller_mixed(vp, vq, fixed, lines, tails))  # twins on the card
    prepared = rows[:PC.line_rows_words(b)].view(LN.VAR_ROWS, 3, 2, 8, b)
    assert torch.equal(prepared, PR.var_line_rows(vp, vq))


def test_prepared_lanes_count_the_groth16_batch_lanes_on_cuda(cuda, tmp_path):
    """``bn254.pairing.prepared_lanes`` under profiling.trace: the lanes of
    one Groth16 batch, none after a PlonK batch."""
    from snark_bn254_verifier_tpu_torch.utils import profiling

    vec = gen_groth16_vector(0)
    ver = Groth16BatchVerifier(vec.vk, device="cuda")
    proofs, inputs = [vec.proof] * B, [list(vec.public_inputs)] * B
    ver.verify_batch(proofs, inputs)  # the VK's set-up, outside the trace
    with profiling.trace(str(tmp_path / "g16.json")):
        assert ver.verify_batch(proofs, inputs).all()
    assert profiling.snapshot()["counters"]["bn254.pairing.prepared_lanes"] == B
    pvec, pproofs, pinputs, expected = plonk_batch_lanes(4, {})
    pver = PlonkBatchVerifier(pvec.vk, device="cuda")
    pver.verify_batch(pproofs, pinputs)
    with profiling.trace(str(tmp_path / "plonk.json")):
        assert pver.verify_batch(pproofs, pinputs).tolist() == expected
    assert "bn254.pairing.prepared_lanes" not in profiling.snapshot()["counters"]


def test_slice_on_cuda(cuda):
    vec = gen_groth16_vector(0)
    proofs = [vec.proof] * B
    inputs = [list(vec.public_inputs) for _ in range(B)]
    inputs[3] = [1, 2]
    PC.reset_launch_counts()
    ok = Groth16BatchVerifier(vec.vk, device="cuda").verify_batch(proofs, inputs)
    assert ok.tolist() == [i != 3 for i in range(B)]
    launches = PC.launch_counts()
    assert all(launches[k] > 0 for k in ("msm_fixed", "g2_lines", "miller_mixed", "final_exp"))
    assert launches["g2_on_curve"] == 1 and launches["mont_mul"] == 0


def test_plonk_batch_on_cuda(cuda):
    """The PlonK batch at B lanes, one bad lane of each kind spread over
    it: the exact bools, one launch each of K7a and K7b, three K2 launches,
    one fixed-only K3, one K4 and nothing else, and the first 8 lanes equal
    to the CPU run."""
    bad = {3 + 2 * k: kind for k, kind in enumerate(KINDS)}
    vec, proofs, inputs, expected = plonk_batch_lanes(B, bad)
    ver = PlonkBatchVerifier(vec.vk, device="cuda")
    rng = random.Random(66)
    PC.reset_launch_counts()
    ok = ver.verify_batch(proofs, inputs, rng=lambda: rng.randrange(1, bn.R))
    assert ok.tolist() == expected
    assert PC.launch_counts() == {"mont_mul": 0, "g2_on_curve": 0, "msm_affine": 3,
                                  "miller_mixed": 1, "final_exp": 1, "miller_product": 0,
                                  "msm_pippenger": 0, "plonk_lanes_a": 1, "plonk_lanes_b": 1,
                                  "msm_fixed": 0, "g2_lines": 0}
    cpu = PlonkBatchVerifier(vec.vk, device="cpu").verify_batch(proofs[:8], inputs[:8])
    assert cpu.tolist() == ok[:8].tolist()


def test_miller_product_kernel_equals_plain(cuda):
    """K5 for 3 pairs (one pass of its four chains) and 5 (two passes),
    with infinite P and Q lanes and a pair infinite by its mask alone."""
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
    assert all(launches[k] > 0 for k in ("msm_fixed", "miller_product", "final_exp"))


@pytest.mark.parametrize("n,c,b,chunk", [(70, 8, 3, 32), (5, 4, 1, 32), (300, 8, 2, 32),
                                         (64, 12, 1, 32), (64, 14, 2, 32), (300, 3, 2, 7),
                                         (40, 5, 3, 1000), (200, 8, 1, 1)])
def test_msm_pippenger_kernel_equals_plain(cuda, n, c, b, chunk):
    """K6 on ragged sizes, window widths and chunk lengths (runs split over
    many chunks, chunks of many whole buckets, c = 14 counting in global
    scratch), with points at infinity, zero scalars and one point repeated
    (P + P in a bucket) on lane 0: one counted launch, exact against its
    plain twin and K2; its halves (window sums, then the combine) too."""
    rng = random.Random(90 + n)
    pool = points(rng, 5)
    lanes = [[pool[(i * j) % 5] if (i + j) % 7 else None for i in range(b)] for j in range(n)]
    for j in range(n):
        lanes[j][0] = pool[0]
    sc = np.stack([FR.pack([rng.randrange(bn.R) if (i + j) % 5 else 0 for i in range(b)],
                           mont=False) for j in range(n)])
    P, S = on(cuda, pair_major(pack_g1, lanes)), torch.as_tensor(sc, device=cuda)
    before = PC.msm_pippenger.launches
    got = PC.msm_pippenger(P, S, c, chunk=chunk)
    assert PC.msm_pippenger.launches == before + 1
    want = M.pippenger_plain(tuple(t.cpu() for t in P), S.cpu(), c)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert all(torch.equal(g, k) for g, k in zip(got, PC.msm_affine(P, S)))
    halves = PC.msm_pippenger_combine(PC.msm_pippenger_windows(P, S, c, chunk).unsqueeze(0), c)
    assert all(torch.equal(g, h) for g, h in zip(got, halves))


def test_msm_pippenger_combine_sums_sets_on_cuda(cuda):
    """K6's combine on three sets of window sums, the kernel's and the
    plain twin's: the affine sum of the three MSMs, equal to the twin's
    combine and to K6 on all the points at once."""
    rng = random.Random(92)
    pool = points(rng, 4)
    pts = [[pool[(i + j) % 4] for i in range(2)] for j in range(96)]
    sc = np.stack([FR.pack([rng.randrange(bn.R) for _ in range(2)], mont=False)
                   for _ in range(96)])
    P, S = on(cuda, pair_major(pack_g1, pts)), torch.as_tensor(sc, device=cuda)
    sets = [PC.msm_pippenger_windows(tuple(t[:32] for t in P), S[:32]),
            M.window_sums_plain(tuple(t[32:64].cpu() for t in P), S[32:64].cpu()).to(cuda),
            PC.msm_pippenger_windows(tuple(t[64:] for t in P), S[64:])]
    got = PC.msm_pippenger_combine(torch.stack(sets))
    assert all(torch.equal(g.cpu(), w) for g, w in
               zip(got, M.combine_plain(torch.stack(sets).cpu())))
    assert all(torch.equal(g, w) for g, w in zip(got, PC.msm_pippenger(P, S)))


def test_torch_backend_msm_large_on_cuda(cuda):
    rng = random.Random(91)
    pool = points(rng, 4)
    pts = [pool[i % 4] for i in range(80)]
    scs = [rng.randrange(bn.R) for _ in range(80)]
    PC.reset_launch_counts()
    got = TorchBackend("cuda").msm(pts, scs)
    assert PC.launch_counts()["msm_pippenger"] == 1 and PC.launch_counts()["msm_affine"] == 0
    agg = {}
    for p, s_ in zip(pts, scs):
        agg[p] = (agg.get(p, 0) + s_) % bn.R
    assert got == bn.g1_msm(list(agg), list(agg.values()))


def test_verify_batch_async_pipelined_on_cuda(cuda):
    """Groth16 and PlonK batches, two in flight on their streams: the exact
    bools on every batch, and per batch one launch each of g2_on_curve,
    msm_fixed, g2_lines, miller_mixed and final_exp (Groth16), three
    msm_affine, one miller_mixed, one final_exp and one each of K7a and K7b
    (PlonK)."""
    from snark_bn254_verifier_tpu_torch.fixtures.groth16_lanes import groth16_batch_lanes

    vec, proofs, inputs, expected = groth16_batch_lanes(B)
    ver = Groth16BatchVerifier(vec.vk, device="cuda")
    ver.verify_batch(proofs, inputs)  # the VK's tensors, outside the counted run
    PC.reset_launch_counts()
    out = [ver.verify_batch_async(proofs, inputs) for _ in range(2)]
    for _ in range(2):
        assert out.pop(0).cpu().tolist() == expected
        out.append(ver.verify_batch_async(proofs, inputs))
    for ok in out:
        assert ok.cpu().tolist() == expected
    n = 4
    assert PC.launch_counts() == {"mont_mul": 0, "g2_on_curve": n, "msm_affine": 0,
                                  "miller_mixed": n, "final_exp": n, "miller_product": 0,
                                  "msm_pippenger": 0, "plonk_lanes_a": 0, "plonk_lanes_b": 0,
                                  "msm_fixed": n, "g2_lines": n}

    bad = {3 + 2 * k: kind for k, kind in enumerate(KINDS)}
    vec, proofs, inputs, expected = plonk_batch_lanes(B, bad)
    ver = PlonkBatchVerifier(vec.vk, device="cuda")
    PC.reset_launch_counts()
    first = ver.verify_batch_async(proofs, inputs)
    second = ver.verify_batch_async(proofs, inputs)
    assert first.cpu().tolist() == expected
    assert ver.verify_batch(proofs, inputs).tolist() == expected
    assert second.cpu().tolist() == expected
    assert PC.launch_counts() == {"mont_mul": 0, "g2_on_curve": 0, "msm_affine": 9,
                                  "miller_mixed": 3, "final_exp": 3, "miller_product": 0,
                                  "msm_pippenger": 0, "plonk_lanes_a": 3, "plonk_lanes_b": 3,
                                  "msm_fixed": 0, "g2_lines": 0}


def plonk_lanes_kernels_against_twins(cuda, b, n_bsb22=1):
    """K7a and K7b against their plain twins on the same CUDA tensors, a
    lane of every kind that fits among b, exact; then the valid bits
    against the expected verdicts."""
    from snark_bn254_verifier_tpu_torch.models.packing import pack_fr_columns
    from snark_bn254_verifier_tpu_torch.ops import plonk_lanes as PL
    from snark_bn254_verifier_tpu_torch.utils import serialization as ser

    bad = {1 + k: kind for k, kind in enumerate(KINDS) if 1 + k < b}
    vec, proofs, inputs, expected = plonk_batch_lanes(b, bad, n_bsb22)
    lvk = PL.LanesVk(ser.load_plonk_verifying_key_from_bytes(vec.vk))
    raw, valid = PL.pack_proofs(proofs, lvk)
    counted = np.array([len(ins) == lvk.nb_pub for ins in inputs])
    pub = pack_fr_columns([ins if c else None for ins, c in zip(inputs, counted)], lvk.nb_pub, b)
    raw, pub, valid = on(cuda, (raw, pub, valid & counted))
    got = PC.plonk_lanes_a(raw, pub, valid, lvk)
    want = PL.plonk_lanes_a_plain(raw, pub, valid, lvk)
    torch.cuda.synchronize()
    for g, w in zip(got[:2] + got[2] + got[3:], want[:2] + want[2] + want[3:]):
        assert torch.equal(g, w)
    doubled = [i for i, k in bad.items() if k in ("opening_doubled", "shifted_doubled")]
    assert got[0].cpu().tolist() == [e or i in doubled for i, e in enumerate(expected)]
    rng = random.Random(b)
    digest = on(cuda, pack_g1([None] + points(rng, b - 1)))
    rand = torch.as_tensor(pack_fr_columns([[rng.randrange(1, bn.R)] for _ in range(b)], 1, b)[0],
                           device=cuda)
    sc = PC.plonk_lanes_b(raw, got[0], got[1], rand, digest, lvk)
    assert torch.equal(sc, PL.plonk_lanes_b_plain(raw, got[0], got[1], rand, digest, lvk))
    return lvk


@pytest.mark.parametrize("b", [1, 37])
def test_plonk_lanes_kernels_equal_plain(cuda, b):
    """K7a and K7b against their plain twins, a lane of every kind (37
    lanes: a ragged second block; 1: one lane)."""
    plonk_lanes_kernels_against_twins(cuda, b)


@pytest.mark.parametrize("n_bsb22", [2, 3])
def test_plonk_lanes_kernels_at_more_commitments(cuda, n_bsb22):
    """A VK of 2 and 3 BSB22 commitments: above 48 KB of dynamic shared
    memory (K7b from 2, K7a from 3), where the entry raises the kernels'
    limit; 37 lanes of every kind against the twins, and the launches'
    shared bytes as the layout gives them."""
    import ctypes

    from snark_bn254_verifier_tpu_torch.ops import _build
    from snark_bn254_verifier_tpu_torch.ops import plonk_cuda as PCU
    from snark_bn254_verifier_tpu_torch.ops.plonk_lanes import proof_bytes

    lvk = plonk_lanes_kernels_against_twins(cuda, 37, n_bsb22)
    assert lvk.nb == n_bsb22
    lib = _build.load_kernels().lib
    for name, per_nb in (("a", {2: 49_152, 3: 53_248}), ("b", {2: 51_584, 3: 56_704})):
        vals = (ctypes.c_int * 6)()
        assert getattr(lib, f"bn_plonk_lanes_{name}_attrs")(vals) == 0
        assert vals[3] == per_nb[n_bsb22]
    assert lib.bn_plonk_max_nb() == PCU.K7_MAX_NB and proof_bytes(n_bsb22) == lvk.proof_len


def test_plonk_lanes_refuse_a_vk_past_the_shared_memory(cuda):
    """A VK of K7_MAX_NB + 1 commitments: both wrappers raise before any
    launch and count none."""
    import copy

    from snark_bn254_verifier_tpu_torch.ops import plonk_cuda as PCU
    from snark_bn254_verifier_tpu_torch.ops import plonk_lanes as PL
    from snark_bn254_verifier_tpu_torch.utils import serialization as ser

    vec, proofs, inputs, _ = plonk_batch_lanes(2, {})
    lvk = copy.copy(PL.LanesVk(ser.load_plonk_verifying_key_from_bytes(vec.vk)))
    lvk.nb = PCU.K7_MAX_NB + 1
    raw = torch.zeros((2, PL.proof_bytes(lvk.nb)), dtype=torch.uint8, device=cuda)
    ok = torch.ones(2, dtype=torch.bool, device=cuda)
    fr = torch.zeros((16, 2), dtype=torch.int32, device=cuda)
    before = (PC.plonk_lanes_a.launches, PC.plonk_lanes_b.launches)
    with pytest.raises(ValueError, match="BSB22 commitments"):
        PC.plonk_lanes_a(raw, torch.zeros((lvk.nb_pub, 16, 2), dtype=torch.int32, device=cuda),
                         ok, lvk)
    with pytest.raises(ValueError, match="BSB22 commitments"):
        PC.plonk_lanes_b(raw, ok, fr, fr, (fr, fr, ok), lvk)
    assert (PC.plonk_lanes_a.launches, PC.plonk_lanes_b.launches) == before


@pytest.fixture(scope="module")
def fixed_table(cuda):
    """Four fixed points (the Groth16 batch's k0..k3 shape, the last at
    infinity) and their window table built on the card by K2, checked
    equal to the plain twin's."""
    from snark_bn254_verifier_tpu_torch.fixtures.msm_lanes import fixed_base_lanes

    pts, _, _ = fixed_base_lanes(4, 1, 110)
    points = on(cuda, pack_g1(pts))
    table = PC.fixed_base_table(points)
    assert torch.equal(table.cpu(), M.fixed_table_plain(tuple(t.cpu() for t in points)))
    return pts, table


@pytest.mark.parametrize("b", [1, 7, 2048, 2049])
def test_msm_fixed_kernel_equals_plain(cuda, fixed_table, b):
    """The fixed-base kernel (4 lanes a block: 7 and 2049 leave the last
    block ragged) exact against its plain twin on the same CUDA tensors
    and against K2 on the points broadcast to the lanes, the edge lanes of
    fixtures/msm_lanes.py::fixed_base_lanes first; one launch. Through
    the C entry on buffers with room past the last lane, nothing is
    stored there."""
    from snark_bn254_verifier_tpu_torch.fixtures.msm_lanes import fixed_base_lanes

    pts, table = fixed_table
    _, scs, _ = fixed_base_lanes(4, max(b, 8), 111 + b)
    sc = on(cuda, (np.stack([FR.pack(s[:b], mont=False) for s in scs]),))[0]
    before = PC.msm_fixed.launches
    got = PC.msm_fixed(table, sc)
    assert PC.msm_fixed.launches == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, M.msm_fixed_plain(table, sc)))
    lanes = on(cuda, pair_major(pack_g1, [[p] * b for p in pts]))
    assert all(torch.equal(g, w) for g, w in zip(got, PC.msm_affine(lanes, sc)))
    ox = torch.full((16 * b + 64,), -7, dtype=torch.int32, device=cuda)
    oy = torch.full_like(ox, -7)
    oinf = torch.full((b + 64,), 7, dtype=torch.uint8, device=cuda)
    PC.launch(cuda, "bn_msm_fixed", table.data_ptr(), sc.data_ptr(), 4, ox.data_ptr(),
              oy.data_ptr(), oinf.data_ptr(), b)
    torch.cuda.synchronize()
    assert torch.equal(ox[:16 * b].view(16, b), got[0])
    assert torch.equal(oinf[:b].bool(), got[2])
    assert (ox[16 * b:] == -7).all() and (oy[16 * b:] == -7).all() and (oinf[b:] == 7).all()


def test_groth16_batch_at_2048_with_every_fault_kind(cuda):
    """The Groth16 batch verifier at 2048 lanes on a 4-point VK (3 inputs,
    the SP1 wrapper's count) with a lane of each of the six fault kinds of
    fixtures/groth16_lanes.py::KINDS: every verdict as expected, and the
    batch's MSM one msm_fixed launch, no K2."""
    from snark_bn254_verifier_tpu_torch.fixtures.groth16_lanes import KINDS, groth16_batch_lanes

    vec, proofs, inputs, expected = groth16_batch_lanes(2048, num_inputs=3)
    assert len(set(KINDS.values())) == 6 and expected.count(False) == 6
    ver = Groth16BatchVerifier(vec.vk, device="cuda")
    assert ver._k_table.shape[0] == 4
    PC.reset_launch_counts()
    ok = ver.verify_batch(proofs, inputs)
    assert ok.tolist() == expected
    launches = PC.launch_counts()
    assert launches["msm_fixed"] == 1 and launches["msm_affine"] == 0

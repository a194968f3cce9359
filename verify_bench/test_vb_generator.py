"""The benchmark's proof generator against its plain reference, on the
CPU: valid proofs verify, every fault kind is rejected, a seed gives the
same pool byte for byte, and the control's broken guarantee accepts
exactly the non-canonical kinds."""

import json
import random
from pathlib import Path

import pytest

from verify_bench.gen import fixed_base, groth16, plonk
from verify_bench.gen.pool import Orders, make_pool
from verify_bench.reference import bn254 as bn

HERE = Path(__file__).resolve().parent
PROTOCOLS = {"sp1-groth16-wrapper": groth16.KINDS, "sp1-plonk-wrapper": plonk.KINDS}
NONCANONICAL = {"noncanonical_a", "noncanonical_x", "claimed_ge_r"}


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.fixture(scope="module", params=sorted(PROTOCOLS))
def pool_and_ref(request):
    cfg = config(request.param)
    kinds = PROTOCOLS[request.param]
    # twice as many invalid as kinds: every kind at least once, each twice
    pool = make_pool(cfg, {"pool": 4 * len(kinds), "bad_share": 0.5}, 2**31 + 17)
    ref = __import__(f"verify_bench.reference.{cfg['protocol']}",
                     fromlist=["verifier"]).verifier(pool.vk, 2**31 + 17)
    return request.param, pool, ref


def test_fixed_base_equals_double_and_add():
    g1, g2 = fixed_base.tables()
    rng = random.Random(5)
    for k in [0, 1, 255, 256, bn.R - 1, bn.R, rng.randrange(bn.R), rng.randrange(bn.R)]:
        assert g1.mul(k) == bn.g1_mul(bn.G1_GEN, k)
        assert g2.mul(k) == bn.g2_mul(bn.G2_GEN, k)


def test_every_kind_in_the_pool(pool_and_ref):
    name, pool, _ = pool_and_ref
    assert set(pool.kinds) == {"valid", *PROTOCOLS[name]}
    assert pool.labels.sum() == len(pool.kinds) // 2


def test_valid_proofs_verify_and_every_fault_is_rejected(pool_and_ref):
    _, pool, ref = pool_and_ref
    for proof, inputs, label, kind in zip(pool.proofs, pool.inputs, pool.labels, pool.kinds):
        assert ref(proof, inputs) == label, kind


def test_control_accepts_only_the_noncanonical_kinds(pool_and_ref):
    _, pool, ref = pool_and_ref
    for proof, inputs, label, kind in zip(pool.proofs, pool.inputs, pool.labels, pool.kinds):
        assert ref(proof, inputs, canonical=False) == (label or kind in NONCANONICAL), kind


def test_items_are_distinct(pool_and_ref):
    _, pool, _ = pool_and_ref
    assert len({(p, tuple(i)) for p, i in zip(pool.proofs, pool.inputs)}) == len(pool.proofs)
    assert len({tuple(i) for i in pool.inputs}) == len(pool.inputs)


@pytest.mark.parametrize("name", sorted(PROTOCOLS))
def test_a_seed_gives_the_same_pool(name):
    cfg = config(name)
    traffic = {"pool": 12, "bad_share": 0.25}
    a, b = make_pool(cfg, traffic, 7), make_pool(cfg, traffic, 7)
    assert (a.vk, a.proofs, a.inputs, a.kinds) == (b.vk, b.proofs, b.inputs, b.kinds)
    c = make_pool(cfg, traffic, 8)
    assert c.vk != a.vk and not set(c.proofs) & set(a.proofs)


def test_orders_are_seeded_permutations():
    a, b = Orders(64, 2**31 + 3), Orders(64, 2**31 + 3)
    x, y = a.batch(64), b.batch(64)
    assert sorted(x.tolist()) == list(range(64)) and (x == y).all()
    assert (a.batch(64) != x).any()
    assert len(set(a.batch(16).tolist())) == 16

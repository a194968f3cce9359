"""The traffic of a cell: a pool of distinct proofs under one VK, and the
order in which the window sends them.

One general generator for every configuration and traffic mix. The
configuration names its ``protocol``: a module of this package with
``KINDS`` and a generator class (and the reference of that name,
verify_bench/reference/<protocol>.py, judges the verdicts). The traffic
file gives the pool's size and the share of invalid proofs, which are
spread over the protocol's fault kinds in turn, at positions drawn from
the seed. Every item is a proof made anew for its own fresh public
inputs; an invalid one is made from a valid pair of its own. The same
seed gives the same pool, byte for byte.

The window reuses the pool: each batch is a fresh seeded permutation of
it (a batch cell), or calls walk through successive permutations (a
single cell). Real traffic never repeats a proof; the reuse is the one
concession, so a program that remembers verdicts across calls would be
giving another result, not a faster one.
"""

from __future__ import annotations

import importlib
import random
from dataclasses import dataclass
from typing import List

import numpy as np

GENERATORS = {"groth16": "Groth16Gen", "plonk": "PlonkGen"}


@dataclass
class Pool:
    vk: bytes
    proofs: List[bytes]
    inputs: List[list]
    labels: np.ndarray  # True where the item is valid by construction
    kinds: List[str]    # "valid" or the fault kind


def protocol_module(cfg: dict):
    return importlib.import_module(f"{__package__}.{cfg['protocol']}")


def bad_count(traffic: dict) -> int:
    return round(traffic["pool"] * traffic["bad_share"])


def make_pool(cfg: dict, traffic: dict, seed: int) -> Pool:
    mod = protocol_module(cfg)
    rng = random.Random(f"{cfg['name']}/{seed}")
    gen = getattr(mod, GENERATORS[cfg["protocol"]])(cfg, rng)
    n = traffic["pool"]
    kinds = list(mod.KINDS)
    rng.shuffle(kinds)
    bad_at = rng.sample(range(n), bad_count(traffic))
    kind_of = {pos: kinds[i % len(kinds)] for i, pos in enumerate(bad_at)}
    proofs, inputs, names = [], [], []
    for i in range(n):
        ins = gen.inputs()
        proof = gen.proof(ins)
        kind = kind_of.get(i, "valid")
        if kind != "valid":
            proof, ins = gen.bad(kind, proof, ins)
        proofs.append(proof)
        inputs.append(ins)
        names.append(kind)
    labels = np.array([k == "valid" for k in names])
    return Pool(gen.vk, proofs, inputs, labels, names)


class Orders:
    """Seeded permutations of the pool, one after another."""

    def __init__(self, n: int, seed: int):
        self.n = n
        self.rng = np.random.default_rng([seed % 2**63, 0x0BDE5])

    def batch(self, size: int) -> np.ndarray:
        """A batch of ``size`` distinct pool indexes (a fresh permutation,
        cut to ``size``)."""
        return self.rng.permutation(self.n)[:size]

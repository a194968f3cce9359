"""Compute-backend interface for the protocol verifiers.

The port's copy of the JAX package's models/backend.py. The verifiers
(models/groth16.py, models/plonk.py) express all heavy math through three
primitives — MSM, pairing, batched pairing — so the same protocol logic
runs against either:

  * the ``oracle`` backend: pure-Python ints (ground truth, always available)
  * a ``TorchBackend`` (models/torch_backend.py): the port's kernels on a
    torch device, passed as an object (it takes the place of the JAX
    package's ``jax`` backend name).

Host-side Fr scalar work (transcript challenges, Lagrange/linearization
algebra) is identical for both backends and stays in Python ints — it is
O(#public inputs) and byte-exactness-critical.
"""

from __future__ import annotations

from ..oracle import bn254 as bn


class OracleBackend:
    """Ground-truth backend on Python ints."""

    name = "oracle"

    @staticmethod
    def msm(points, scalars):
        return bn.g1_msm(points, scalars)

    @staticmethod
    def g1_mul(point, scalar):
        return bn.g1_mul(point, scalar)

    @staticmethod
    def pairing(p, q):
        return bn.pairing(p, q)

    @staticmethod
    def pairing_batch(pairs):
        return bn.pairing_batch(pairs)

    @staticmethod
    def pairing_batch_is_one(pairs):
        return bn.fq12_is_one(bn.pairing_batch(pairs))


_DEFAULT = OracleBackend()


def get_backend(name_or_backend="default"):
    """The oracle backend for "default", "oracle" or None; any object with
    the backend's primitives (a TorchBackend) as it is."""
    if name_or_backend in ("default", "oracle", None):
        return _DEFAULT
    if hasattr(name_or_backend, "pairing_batch"):
        return name_or_backend
    raise ValueError(f"unknown backend {name_or_backend!r}")

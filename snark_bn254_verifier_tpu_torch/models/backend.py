"""Compute-backend interface for the protocol verifiers.

The port's copy of the JAX package's models/backend.py. The verifiers
(models/groth16.py, models/plonk.py) express all heavy math through three
primitives — MSM, pairing, batched pairing — so the same protocol logic
runs against either:

  * the ``oracle`` backend: pure-Python ints (ground truth, always available)
  * the ``torch`` backend (models/torch_backend.py::TorchBackend): the
    port's kernels on a torch device, the counterpart of the JAX
    package's ``jax`` backend. ``get_backend("torch")`` is the instance on
    the card; ``"torch:cpu"`` (or ``"torch:cuda:1"``) names the device.

The default backend, which a protocol function or facade called without
one uses, is ``torch`` on the card (the JAX package's is the oracle, its
device backend being opt-in); ``set_default_backend`` changes it.

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


_ORACLE = OracleBackend()
_default_name = "torch"


def get_backend(name_or_backend="default"):
    """The default backend for "default" or None, the oracle for "oracle",
    ``TorchBackend.instance()`` for "torch" (on the card, which raises
    where there is none) or "torch:<device>"; any object with the
    backend's primitives (a TorchBackend) as it is."""
    if name_or_backend in ("default", None):
        return get_backend(_default_name)
    if name_or_backend == "oracle":
        return _ORACLE
    if isinstance(name_or_backend, str):
        kind, _, device = name_or_backend.partition(":")
        if kind == "torch":
            from .torch_backend import TorchBackend

            return TorchBackend.instance(device or "cuda")
    elif hasattr(name_or_backend, "pairing_batch"):
        return name_or_backend
    raise ValueError(f"unknown backend {name_or_backend!r}")


def set_default_backend(name: str) -> None:
    """The backend that ``get_backend()`` (and so every facade and
    protocol function called without one) returns from now on."""
    global _default_name
    _default_name = name


def facade_backend(device=None):
    """The backend of a facade call: the torch backend on ``device`` where
    one is named, else the default backend."""
    if device is None:
        return get_backend()
    from .torch_backend import TorchBackend

    return TorchBackend.instance(device)

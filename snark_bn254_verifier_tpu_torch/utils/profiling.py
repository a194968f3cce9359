"""Run statistics of the batch verifier.

The port's copy of ``RunStats`` from the JAX package's utils/profiling.py,
the only part of that module the port uses.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class RunStats:
    """Structured throughput record for a verification run."""

    protocol: str
    batch_size: int
    n_chips: int
    elapsed_s: float
    n_valid: int
    mesh_shape: tuple = ()
    pairings_per_proof: int = 3
    extra: dict = field(default_factory=dict)

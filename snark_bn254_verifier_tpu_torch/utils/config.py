"""Run configuration of the batched and sharded paths.

The port's copy of the JAX package's utils/config.py: the same
``VerifierConfig`` fields and defaults. The bench's run (bench.py::Run)
extends it and reads ``batch_size`` and ``msm_window_bits``;
``cache_dir`` names the port's kernel build directory (``_build/``,
ignored by git), from which ops/_build.py takes its default as the JAX
package's ``enable_compilation_cache`` takes its XLA cache's. That cache
has no counterpart here. ``mesh_shape`` and ``mesh_axis_names`` are kept
for the JAX dataclass's sake; nothing reads them there either.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple


@dataclass
class VerifierConfig:
    batch_size: int = 256          # proofs per device batch
    mesh_shape: Tuple[int, ...] = ()  # () = single device
    mesh_axis_names: Tuple[str, ...] = ("data",)
    msm_window_bits: int = 4
    cache_dir: str = os.path.join(os.path.dirname(__file__), "..", "_build")

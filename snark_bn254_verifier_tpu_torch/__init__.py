"""PyTorch + CUDA port of the batched BN254 Groth16 verifier.

The JAX package ``snark_bn254_verifier_tpu`` beside this one is the
reference: every module here names its counterpart there, keeps its
``(16, *batch)`` 16-bit-limb layout at the public functions, and is held
against it bit for bit by tests/test_torch_*.py. This package imports
``torch`` and never JAX; from the JAX package it uses only the JAX-free
host modules (oracle, serialization, native parser, errors, profiling,
fixtures).

    from snark_bn254_verifier_tpu_torch import Groth16BatchVerifier
    ok = Groth16BatchVerifier(vk_bytes, device="cuda").verify_batch(proofs, inputs)

On a CUDA device the path runs through four hand-written kernels
(csrc/kernels.cu, built by nvcc on first use); on the CPU it runs their
plain PyTorch twins.
"""

from .ops.pairing_cuda import KERNEL_ENTRY_POINTS
from .parallel.batch import Groth16BatchVerifier

__all__ = ["Groth16BatchVerifier", "KERNEL_ENTRY_POINTS"]

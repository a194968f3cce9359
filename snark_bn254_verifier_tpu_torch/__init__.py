"""PyTorch + CUDA port of the BN254 Groth16 / PlonK verifier.

The JAX package ``snark_bn254_verifier_tpu`` beside this one is the
reference: every module here names its counterpart there, keeps its
``(16, *batch)`` 16-bit-limb layout at the public functions, and is held
against it bit for bit by tests/test_torch_*.py. This package imports
``torch`` and never JAX; from the JAX package it uses only the JAX-free
host modules (oracle, serialization, native parser, errors, profiling,
fixtures, and the protocol logic of models/{groth16,plonk,kzg,backend}).

    from snark_bn254_verifier_tpu_torch import Groth16Verifier, PlonkVerifier
    ok = Groth16Verifier.verify(proof, vk, public_inputs, device="cuda")
    ok = PlonkVerifier.verify(proof, vk, public_inputs, device="cuda")

    from snark_bn254_verifier_tpu_torch import Groth16BatchVerifier
    ok = Groth16BatchVerifier(vk_bytes, device="cuda").verify_batch(proofs, inputs)

On a CUDA device both paths run through five hand-written kernels
(csrc/kernels.cu, built by nvcc on first use); on the CPU they run their
plain PyTorch twins.
"""

from .models.groth16 import Groth16Verifier
from .models.plonk import PlonkVerifier
from .models.torch_backend import TorchBackend
from .ops.pairing_cuda import KERNEL_ENTRY_POINTS
from .parallel.batch import Groth16BatchVerifier

__all__ = ["Groth16BatchVerifier", "Groth16Verifier", "KERNEL_ENTRY_POINTS",
           "PlonkVerifier", "TorchBackend"]

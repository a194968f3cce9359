"""PyTorch + CUDA port of the BN254 Groth16 / PlonK verifier.

The JAX package ``snark_bn254_verifier_tpu`` beside this one is the
reference: every module here names its counterpart there, keeps its
``(16, *batch)`` 16-bit-limb layout at the public functions, and is held
against it bit for bit by tests/test_torch_*.py. This package imports
``torch`` and never JAX, and nothing of the JAX package: it keeps its own
copies of the host modules it needs (oracle/, utils/, fixtures/, the
protocol code in models/{groth16,plonk,kzg,backend}.py, and the native
parser in csrc/host/), in the JAX package's structure and names.

    from snark_bn254_verifier_tpu_torch import Groth16Verifier, PlonkVerifier
    ok = Groth16Verifier.verify(proof, vk, public_inputs, device="cuda")
    ok = PlonkVerifier.verify(proof, vk, public_inputs, device="cuda")

    from snark_bn254_verifier_tpu_torch import Groth16BatchVerifier, PlonkBatchVerifier
    ok = Groth16BatchVerifier(vk_bytes, device="cuda").verify_batch(proofs, inputs)
    ok = PlonkBatchVerifier(vk_bytes, device="cuda").verify_batch(proofs, inputs)

Every entry point defaults to ``device="cuda"`` and raises where there is
no card; the facades run on the default backend, ``torch`` on the card,
unless given a ``device`` (``set_default_backend`` changes the default,
``get_backend("oracle")`` is the pure-Python one). On a CUDA device the
paths run through the port's hand-written
kernels (csrc/, built by nvcc on first use); with ``device="cpu"`` they
run their plain PyTorch twins.
"""

from .models.backend import get_backend, set_default_backend
from .models.groth16 import Groth16Verifier, PreparedVerifyingKey, verify_groth16
from .models.plonk import PlonkVerifier, verify_plonk
from .models.torch_backend import TorchBackend
from .ops.pairing_cuda import KERNEL_ENTRY_POINTS
from .parallel.batch import Groth16BatchVerifier, PlonkBatchVerifier
from .utils import errors

__all__ = ["Groth16BatchVerifier", "Groth16Verifier", "KERNEL_ENTRY_POINTS",
           "PlonkBatchVerifier", "PlonkVerifier", "PreparedVerifyingKey", "TorchBackend",
           "errors", "get_backend", "set_default_backend", "verify_groth16", "verify_plonk"]

__version__ = "0.1.0"

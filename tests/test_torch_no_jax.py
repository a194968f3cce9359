"""The PyTorch port stands alone: with JAX and the JAX package
(``snark_bn254_verifier_tpu``) both blocked, importing it, building a CPU
batch verifier from its own fixtures, importing the single-proof facades,
the large MSM and the sharded layer, building a CPU TorchBackend,
importing chip_smoke, and importing the bench and its tooling (bench,
weak_scaling, utils/{roofline,config,profiling}, fixtures/extract_vk;
the roofline counts on the twins) all work, and no file of the package or chip_smoke.py
imports either of them."""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "snark_bn254_verifier_tpu_torch"

_CHILD = r"""
import importlib.abc, sys

BLOCKED = ("jax", "jaxlib", "snark_bn254_verifier_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in this test")
        return None

sys.meta_path.insert(0, Block())
import snark_bn254_verifier_tpu_torch as port
from snark_bn254_verifier_tpu_torch.fixtures.gen import gen_groth16_vector
ver = port.Groth16BatchVerifier(gen_groth16_vector(0).vk, device="cpu")
ver.line_tables()
from snark_bn254_verifier_tpu_torch import Groth16Verifier, PlonkVerifier, TorchBackend
from snark_bn254_verifier_tpu_torch import examples
from snark_bn254_verifier_tpu_torch.models.backend import get_backend
from snark_bn254_verifier_tpu_torch.ops import msm
from snark_bn254_verifier_tpu_torch.parallel import sharded
assert msm.PIPPENGER_THRESHOLD == 16 and callable(sharded.sharded_msm)
backend = TorchBackend("cpu")
assert get_backend(backend) is backend
assert backend.msm([], []) is None
import chip_smoke
assert set(chip_smoke.KERNEL_PHASES) == set(port.KERNEL_ENTRY_POINTS)
from snark_bn254_verifier_tpu_torch import bench, weak_scaling
from snark_bn254_verifier_tpu_torch.utils import config, profiling, roofline
from snark_bn254_verifier_tpu_torch.fixtures import extract_vk
assert roofline.groth16_mults_per_proof(2) == 50866
assert callable(profiling.trace) and config.VerifierConfig().batch_size == 256
assert callable(extract_vk.extract) and callable(weak_scaling.run)
assert set(bench.RUNNERS) == set(bench.ORDER) and port.get_backend("oracle").name == "oracle"
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("no-jax ok")
"""


def test_port_imports_and_builds_a_verifier_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "no-jax ok" in proc.stdout


def test_no_source_file_imports_jax():
    """Neither JAX nor the JAX package, by absolute import."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|snark_bn254_verifier_tpu)\b(?!_)",
                         re.MULTILINE)
    sources = [p for p in PKG.rglob("*.py") if "_build" not in p.relative_to(PKG).parts]
    offenders = [str(p) for p in sources + [REPO / "chip_smoke.py"]
                 if pattern.search(p.read_text())]
    assert offenders == []

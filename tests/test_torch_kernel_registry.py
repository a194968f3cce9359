"""The port's kernel registry and on-card coverage contract (the counterpart
of tests/test_kernel_registry.py): every wrapper that launches a CUDA
kernel carries a launch counter and is listed in
ops/pairing_cuda.py::KERNEL_ENTRY_POINTS, and chip_smoke.py has an on-card
phase for every entry, so no kernel ships without an on-card check."""

import importlib.util
from pathlib import Path

import pytest

from snark_bn254_verifier_tpu_torch.ops import pairing_cuda as PC

pytestmark = pytest.mark.smoke

REPO = Path(__file__).resolve().parents[1]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_registry_matches_wrappers_with_launch_counters():
    counted = {
        name for name in dir(PC)
        if not name.startswith("_") and callable(getattr(PC, name))
        and isinstance(getattr(getattr(PC, name), "launches", None), int)
    }
    assert counted == set(PC.KERNEL_ENTRY_POINTS)
    assert set(PC.launch_counts()) == set(PC.KERNEL_ENTRY_POINTS)


def test_every_kernel_has_a_chip_smoke_phase():
    smoke = _load_chip_smoke()
    assert set(smoke.KERNEL_PHASES) == set(PC.KERNEL_ENTRY_POINTS)
    assert set(smoke.REPLACES) == set(PC.KERNEL_ENTRY_POINTS)


def test_every_kernel_has_a_cuda_entry_point():
    """A C entry point and a __global__ kernel in csrc/*.cu: bn_<name> in
    kernels.cu, or bn_<name>_t<team> (BN_NAME) in team_kernels.cu."""
    csrc = REPO / "snark_bn254_verifier_tpu_torch" / "csrc"
    src = "".join(p.read_text() for p in sorted(csrc.glob("*.cu")))
    for name in PC.KERNEL_ENTRY_POINTS:
        entry = f"int bn_{name}(" in src or f"int BN_NAME(bn_{name})(" in src
        assert entry and f"__global__ void {name}_kernel(" in src, name


def test_chip_smoke_paths_launch_every_kernel():
    """The kernels chip_smoke requires of its paths (the Groth16 slice, the
    PlonK batch, the single proofs, the large MSM) cover the registry but
    the kernels no path launches; the PlonK batch launches no G2 kernel,
    and the large MSM launches K6."""
    smoke = _load_chip_smoke()
    paths = (set(smoke.SLICE_KERNELS) | set(smoke.PLONK_BATCH_KERNELS)
             | set(smoke.SINGLE_KERNELS) | set(smoke.LARGE_MSM_KERNELS))
    assert paths == set(PC.KERNEL_ENTRY_POINTS) - set(smoke.UNLAUNCHED)
    assert set(smoke.LARGE_MSM_KERNELS) == {"msm_pippenger"}
    assert set(smoke.PLONK_BATCH_KERNELS) == {"msm_affine", "miller_mixed", "final_exp"}

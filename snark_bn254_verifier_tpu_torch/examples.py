"""Example command line of the port's single-proof API, on a CPU or a CUDA device.

The counterpart of snark_bn254_verifier_tpu/examples.py (the reference's
host CLI, examples/script/src/main.rs:18-36), with ``--device``
in place of ``--backend``:

  * ``--synthetic``: trapdoor test vectors in exact gnark byte format
    (fixtures/gen.py), verified by the port's facades.
  * ``--golden`` / ``--all-golden``: the golden SP1 wrapper binaries of the
    reference checkout: structure, canonical encodings and on-curve checks,
    then full verification where a VK is at hand (the committed PlonK VK,
    or ``--vk PATH``). A missing binary is reported as not found.

Usage:
    python -m snark_bn254_verifier_tpu_torch.examples --synthetic --mode plonk --device cuda
    python -m snark_bn254_verifier_tpu_torch.examples --all-golden --device cuda
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
# the reference checkout sits beside this repository
GOLDEN_DIR = str(_PKG.parents[1] / "reference" / "examples" / "binaries")
ELFS = ["fibonacci", "is-prime", "sha2", "tendermint"]
PLONK_VK = str(_PKG / "fixtures" / "plonk_vk.bin")


def _verifier(mode: str):
    from . import Groth16Verifier, PlonkVerifier

    return Groth16Verifier if mode == "groth16" else PlonkVerifier


def run_golden(elf: str, mode: str, vk_path: str | None, device: str) -> int:
    from .oracle import bn254 as bn
    from .utils import serialization as ser
    from .utils.sp1_wrapper import load_sp1_wrapper

    path = os.path.join(GOLDEN_DIR, f"{elf}_{mode}_proof.bin")
    if not os.path.exists(path):
        print(f"golden vector not found: {path}")
        return 1
    w = load_sp1_wrapper(path)
    print(f"{elf}/{mode}: raw_proof {len(w.raw_proof)}B, "
          f"public inputs {[str(v)[:18] + '...' for v in w.public_inputs]}")
    if mode == "groth16":
        proof = ser.load_groth16_proof_from_bytes(w.raw_proof)
        ok = bn.g1_is_on_curve(proof.ar) and bn.g1_is_on_curve(proof.krs)
        ok &= bn.g2_is_on_curve(proof.bs)
    else:
        proof = ser.load_plonk_proof_from_bytes(w.raw_proof)
        pts = list(proof.lro) + [proof.z, *proof.h, proof.batched_proof.h,
                                 proof.z_shifted_opening.h] + proof.bsb22_commitments
        ok = all(bn.g1_is_on_curve(p) for p in pts)
    print(f"  structure + canonical encodings + on-curve: {'OK' if ok else 'FAIL'}")
    if vk_path is None and mode == "plonk" and os.path.exists(PLONK_VK):
        vk_path = PLONK_VK  # the SP1 PlonK VK is committed; the Groth16 one never shipped
    if vk_path:
        with open(os.path.expanduser(vk_path), "rb") as fh:
            vk = fh.read()
        t0 = time.perf_counter()
        result = _verifier(mode).verify(w.raw_proof, vk, w.public_inputs, device=device)
        print(f"  full verification: {result} ({time.perf_counter() - t0:.3f}s, device={device})")
        return 0 if result else 1
    print("  (full verification needs the SP1 circuit VK: pass --vk PATH)")
    return 0 if ok else 1


def run_synthetic(mode: str, device: str) -> int:
    from .fixtures.gen import gen_groth16_vector, gen_plonk_vector

    vec = gen_groth16_vector(0) if mode == "groth16" else gen_plonk_vector(0)
    t0 = time.perf_counter()
    ok = _verifier(mode).verify(vec.proof, vec.vk, vec.public_inputs, device=device)
    print(f"synthetic {mode} verify: {ok} ({time.perf_counter() - t0:.3f}s, device={device})")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="snark_bn254_verifier_tpu_torch.examples")
    ap.add_argument("--elf", choices=ELFS, default="fibonacci")
    ap.add_argument("--mode", choices=["groth16", "plonk"], default="groth16")
    ap.add_argument("--golden", action="store_true")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--all-golden", action="store_true")
    ap.add_argument("--vk", default=None, help="SP1 circuit VK path")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    args = ap.parse_args(argv)

    if args.all_golden:
        rc = 0
        for elf in ELFS:
            for mode in ("groth16", "plonk"):
                rc |= run_golden(elf, mode, args.vk, args.device)
        return rc
    if args.golden:
        return run_golden(args.elf, args.mode, args.vk, args.device)
    return run_synthetic(args.mode, args.device)


if __name__ == "__main__":
    sys.exit(main())

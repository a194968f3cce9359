"""Build and load the port's CUDA kernels (nvcc + ctypes).

``load_kernels()`` compiles the units of csrc/ (``UNITS``), one ``nvcc``
each, all at once, and links them into a shared library with a plain C
interface under the package's ``_build/`` directory (ignored by git),
rebuilding whenever a source is newer than the library, and loads it with
ctypes. The repository's sources are the
only inputs: the constants header is generated here from the oracle, so
nothing numeric is typed by hand. ``load_host_check()`` builds the same
headers with the host C++ compiler into a test-only library.

Nothing here runs at import time, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

from ..oracle import bn254 as bn
from ..utils.config import VerifierConfig
from .limbs import FQ, FR, int_to_words
from .lines import MILLER_BITS

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = Path(VerifierConfig().cache_dir).resolve()
CONSTS_HEADER = "bn254_consts.h"
CUDA_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
STACK_BYTES = 16384  # per-thread stack for the __noinline__ call chain of K4's Fq12 inverse

_P = ctypes.c_void_p
_N = ctypes.c_longlong
_I = ctypes.c_int


def consts_header() -> str:
    """The kernels' constants, derived from the oracle: moduli, Montgomery
    constants (R = 2^256, n0' = -p^-1 mod 2^32, R^3 mod p), the Fq
    inversion exponent, the twist's curve constant b' and the Frobenius
    coefficients (Montgomery form), and the loop bit schedules."""

    def words(v):
        return ", ".join(f"0x{w:08x}u" for w in int_to_words(v))

    def fq2_words(v):
        return f"{words(FQ.to_mont_int(v[0]))},\n  {words(FQ.to_mont_int(v[1]))}"

    frob = [
        fq2_words(bn.fq2_pow(bn.XI, i * (bn.P**power - 1) // 6))
        for power in (1, 2, 3)
        for i in range(6)
    ]
    twist = [
        fq2_words(bn.fq2_pow(bn.XI, (bn.P**power - 1) // k))
        for power in (1, 2)
        for k in (3, 2)
    ]
    x_bits = [int(c) for c in bin(bn.X_PARAM)[2:]]
    out = [
        "// Generated by snark_bn254_verifier_tpu_torch/ops/_build.py from",
        "// oracle/bn254.py. Do not edit.",
        "#pragma once",
        f"#define BN_FQ_N0 0x{FQ.n0inv32:08x}u",
        f"#define BN_FR_N0 0x{FR.n0inv32:08x}u",
        f"#define BN_FQ_PM2_NBITS {(bn.P - 2).bit_length()}",
        f"#define BN_MILLER_STEPS {len(MILLER_BITS)}",
        f"#define BN_X_NBITS {len(x_bits)}",
        f"BN_CONST uint32_t FQ_MOD[8] = {{{words(bn.P)}}};",
        f"BN_CONST uint32_t FQ_ONE[8] = {{{words(FQ.r_mod)}}};",
        f"BN_CONST uint32_t FQ_PM2[8] = {{{words(bn.P - 2)}}};",
        f"BN_CONST uint32_t FQ_R3[8] = {{{words(pow(2, 768, bn.P))}}};",
        f"BN_CONST uint32_t FR_MOD[8] = {{{words(bn.R)}}};",
        f"BN_CONST uint32_t FR_ONE[8] = {{{words(FR.r_mod)}}};",
        "// R^2 (and R^3 for r): a product by them takes a value into Montgomery form",
        f"BN_CONST uint32_t FQ_R2[8] = {{{words(FQ.r2)}}};",
        f"BN_CONST uint32_t FR_R2[8] = {{{words(FR.r2)}}};",
        f"BN_CONST uint32_t FR_R3[8] = {{{words(pow(2, 768, bn.R))}}};",
        "// r in nine 30-bit limbs and r^-1 mod 2^30: the divsteps inverse (plonk.cuh)",
        "BN_CONST int32_t FR_MOD_S30[9] = {"
        + ", ".join(str((bn.R >> (30 * i)) & ((1 << 30) - 1)) for i in range(9)) + "};",
        f"#define BN_FR_INV30 0x{pow(bn.R, -1, 1 << 30):08x}u",
        "// b = 3 of G1: y^2 = x^3 + b, Montgomery form",
        f"BN_CONST uint32_t G1_B_MONT[8] = {{{words(FQ.to_mont_int(bn.B_G1))}}};",
        "// b' = 3 / XI of the twist E'/Fq2: y^2 = x^3 + b'",
        f"BN_CONST uint32_t TWIST_B[2 * 8] = {{\n  {fq2_words(bn.B_G2)}}};",
        "// gamma_{power,i} = XI^(i (p^power - 1) / 6), power 1..3, i 0..5",
        "BN_CONST uint32_t FROB_GAMMA[3 * 6 * 2 * 8] = {\n  "
        + ",\n  ".join(frob) + "};",
        "// untwist-Frobenius: power 1..2, (XI^((p^k-1)/3), XI^((p^k-1)/2))",
        "BN_CONST uint32_t TWIST_FROB[2 * 2 * 2 * 8] = {\n  "
        + ",\n  ".join(twist) + "};",
        "BN_CONST uint8_t MILLER_BITS[BN_MILLER_STEPS] = {"
        + ", ".join(map(str, MILLER_BITS)) + "};",
        "BN_CONST uint8_t X_BITS[BN_X_NBITS] = {"
        + ", ".join(map(str, x_bits)) + "};",
    ]
    return "\n".join(out) + "\n"


def _write_consts(build_dir: Path) -> Path:
    """Write the constants header, keeping its mtime when unchanged."""
    build_dir.mkdir(parents=True, exist_ok=True)
    path = build_dir / CONSTS_HEADER
    text = consts_header()
    if not path.exists() or path.read_text() != text:
        path.write_text(text)
    return path


def _stale(lib: Path, inputs) -> bool:
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(p.stat().st_mtime > built for p in inputs)


def _compile(cmd, lib: Path) -> str:
    """Run a compiler command that writes ``lib`` via a temporary name, so
    a concurrent loader never sees a half-written library."""
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(cmd + ["-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"kernel build failed ({' '.join(cmd)}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return proc.stdout + proc.stderr


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default prefix
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


@dataclass
class KernelLib:
    lib: ctypes.CDLL
    build_s: float   # seconds spent compiling in this process (0 if cached)
    build_log: str   # nvcc/ptxas output of that build ("" if cached)


def team_unit(k: int) -> tuple:
    """The unit of team kernel K<k>: team_kernels.cu with -DBN_TEAM_KERNEL=k."""
    return ("team_kernels.cu", (f"-DBN_TEAM_KERNEL={k}",))


# One nvcc per compiled unit, all started together: (source, defines).
# team_kernels.cu is built once per team kernel (K2-K5); pippenger.cu is K6,
# built twice: its stages 1-5 and its combine (pippenger.cu's head comment);
# plonk_kernels.cu is K7, the PlonK batch's lane pass; msm_fixed.cu the
# fixed-base MSM of the Groth16 prepared input; g2_lines.cu the variable
# pair's line rows that K3 reads in the Groth16 batch.
UNITS = ([("kernels.cu", ())] + [team_unit(k) for k in (2, 3, 4, 5)]
         + [("pippenger.cu", (f"-DBN_PIP_COMBINE={k}",)) for k in (0, 1)]
         + [("plonk_kernels.cu", ()), ("msm_fixed.cu", ()), ("g2_lines.cu", ())])
OBJ_DIR = BUILD_DIR / "obj"


def unit_object(obj_dir: Path, unit) -> Path:
    src, defines = unit
    return obj_dir / ("_".join([Path(src).stem] + [d.split("=")[-1] for d in defines]) + ".o")


def start_units(nvcc: str, csrc: Path, obj_dir: Path, units) -> list:
    """Start one nvcc per unit of ``units`` (sources in ``csrc``, objects
    into ``obj_dir``); returns [(cmd, object, process)] for finish_units."""
    obj_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for unit in units:
        src, defines = unit
        obj = unit_object(obj_dir, unit)
        cmd = [nvcc, CUDA_ARCH, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", *defines, "-I", str(BUILD_DIR), "-I", str(csrc),
               str(csrc / src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    return procs


def finish_units(procs) -> tuple:
    """Wait for start_units' compilers; returns (objects, their ptxas
    reports). Raises on a failed unit."""
    t0, logs = time.perf_counter(), []
    for cmd, obj, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n{out}")
        logs.append(f"{obj.name}: done after {time.perf_counter() - t0:.1f} s\n{out}")
    return [obj for _, obj, _ in procs], "".join(logs)


def link_library(nvcc: str, objects, lib_path: Path) -> str:
    """Link compiled units into the shared kernel library ``lib_path``."""
    return _compile([nvcc, CUDA_ARCH, "-shared"] + [str(o) for o in objects], lib_path)


@functools.lru_cache(maxsize=None)
def load_kernels() -> KernelLib:
    """Build (if stale) and load the CUDA kernel library."""
    consts = _write_consts(BUILD_DIR)
    lib_path = BUILD_DIR / "libbn254_kernels.so"
    inputs = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")) + [consts]
    t0 = time.perf_counter()
    log = ""
    if _stale(lib_path, inputs):
        nvcc = find_nvcc()
        objects, log = finish_units(start_units(nvcc, CSRC, OBJ_DIR, UNITS))
        log += link_library(nvcc, objects, lib_path)
        (BUILD_DIR / "nvcc.log").write_text(log)
    build_s = time.perf_counter() - t0 if log else 0.0
    return KernelLib(bind_kernels(lib_path), build_s, log)


def bind_kernels(lib_path: Path) -> ctypes.CDLL:
    """Load a built kernel library and declare its C interface. Each
    device still needs ``bn_init(STACK_BYTES)`` before its first launch
    (ops/field_cuda.py::launch)."""
    lib = ctypes.CDLL(str(lib_path))
    lib.bn_error_string.argtypes = [_I]
    lib.bn_error_string.restype = ctypes.c_char_p
    sigs = {
        "bn_init": [_N],
        "bn_mont_mul": [_P, _P, _P, _N, _I, _P],
        "bn_g2_on_curve": [_P, _P, _P, _P, _P, _N, _P],
        "bn_msm_affine": [_P, _P, _P, _P, _I, _P, _P, _P, _N, _P],
        "bn_miller_mixed": [_P] * 3 + [_I, _P, _P, _P, _N, _P],
        "bn_g2_lines": [_P] * 5 + [_N, _P],
        "bn_final_exp": [_P, _P, _N, _P],
        "bn_miller_product": [_P] * 4 + [_I, _P, _N, _P],
        "bn_msm_pippenger": [_P] * 4 + [_I, _I, _I] + [_P] * 5 + [_N, _P],
        "bn_msm_pippenger_windows": [_P] * 4 + [_I, _I, _I, _P, _P, _N, _P, _P],
        "bn_msm_pippenger_combine": [_P, _I, _I, _P, _P, _P, _N, _P],
        "bn_plonk_lanes_a": [_P, _N] + [_P] * 9 + [_N, _P],
        "bn_plonk_lanes_b": [_P, _N] + [_P] * 8 + [_N, _P],
        "bn_plonk_max_nb": [],
        "bn_msm_fixed": [_P, _P, _I, _P, _P, _P, _N, _P],
        "bn_mont_mul_attrs": [_P],
        "bn_g2_on_curve_attrs": [_P],
        "bn_msm_affine_attrs": [_P],
        "bn_miller_mixed_attrs": [_P],
        "bn_final_exp_attrs": [_P],
        "bn_miller_product_attrs": [_P],
        "bn_msm_pippenger_attrs": [_P],
        "bn_msm_pippenger_stage_attrs": [_P],
        "bn_msm_pippenger_combine_attrs": [_P],
        "bn_plonk_lanes_a_attrs": [_P],
        "bn_plonk_lanes_b_attrs": [_P],
        "bn_msm_fixed_attrs": [_P],
        "bn_g2_lines_attrs": [_P],
        "bn_msm_affine_occupancy": [_P],
        "bn_miller_mixed_occupancy": [_P],
        "bn_g2_lines_occupancy": [_P],
    }
    for fn, args in sigs.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = _I
    lib.bn_msm_pippenger_scratch_bytes.argtypes = [_I, _I, _N, _I]
    lib.bn_msm_pippenger_scratch_bytes.restype = _N
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by an entry point."""
    if code != 0:
        msg = lib.bn_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


@functools.lru_cache(maxsize=None)
def load_host_check(rolled: bool = False) -> ctypes.CDLL:
    """Build the kernels' headers with the host C++ compiler into a test
    library (csrc/host_check.cc) and load it; ``rolled`` builds it with
    the rolled Montgomery product (-DBN_ROLLED_CIOS=1), the form that
    team_kernels.cu gives K2 and K5, pippenger.cu K6 and g2_lines.cu
    g2_lines."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler")
    build_dir = BUILD_DIR / "host"
    consts = _write_consts(build_dir)
    lib_path = build_dir / f"libbn254_host_check{'_rolled' if rolled else ''}.so"
    src = CSRC / "host_check.cc"
    inputs = [src, consts] + sorted(CSRC.glob("*.cuh"))
    if _stale(lib_path, inputs):
        _compile([cxx, "-O1", "-std=c++20", "-shared", "-fPIC",
                  f"-DBN_ROLLED_CIOS={int(rolled)}",
                  "-I", str(build_dir), "-I", str(CSRC), str(src)], lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.host_mont_mul.argtypes = [_P, _P, _P, _N, _I, _I]
    lib.host_fq_inv.argtypes = [_P, _P, _N, _I]
    lib.host_g2_on_curve.argtypes = [_P, _P, _P, _P, _P, _N]
    lib.host_fq12_mul.argtypes = [_P, _P, _P, _N, _I]
    lib.host_msm_affine.argtypes = [_P, _P, _P, _P, _I, _P, _P, _P, _N]
    lib.host_msm_fixed.argtypes = [_P, _P, _I, _P, _P, _P, _N]
    lib.host_g2_lines.argtypes = [_P] * 5 + [_N]
    lib.host_miller_mixed.argtypes = [_P] * 3 + [_I, _P, _P, _P, _N]
    lib.host_final_exp.argtypes = [_P, _P, _N]
    lib.host_miller_product.argtypes = [_P] * 4 + [_I, _P, _N]
    lib.host_msm_pippenger.argtypes = [_P] * 4 + [_I, _I, _I] + [_P] * 5 + [_N]
    lib.host_pip_layout.argtypes = [_I, _I, _N, _I, _P]
    lib.host_pip_layout.restype = _N
    lib.host_pip_sort.argtypes = [_P, _P, _I, _I, _I, _P, _N]
    lib.host_pip_buckets.argtypes = [_P, _P, _I, _I, _I, _P, _N]
    lib.host_pip_reduce.argtypes = [_I, _I, _I, _P, _P, _N]
    lib.host_pip_combine.argtypes = [_P, _I, _I, _P, _P, _P, _N]
    lib.host_sha256.argtypes = [_P, _N, _P, _N, _P]
    lib.host_sha256_lead.argtypes = [_P, _N, _P, _N, _I, _P]
    lib.host_fr_inv.argtypes = [_P, _P, _N]
    lib.host_plonk_lanes_a.argtypes = [_P, _N] + [_P] * 9 + [_N]
    lib.host_plonk_lanes_b.argtypes = [_P, _N] + [_P] * 8 + [_N]
    lib.host_plonk_lanes_a_ordered.argtypes = [_P, _N] + [_P] * 9 + [_N, _I]
    lib.host_plonk_lanes_b_ordered.argtypes = [_P, _N] + [_P] * 8 + [_N, _I]
    lib.host_plonk_smem_bytes.argtypes = [_N, _I, _I]
    lib.host_plonk_smem_bytes.restype = _N
    lib.host_plonk_max_nb.argtypes = []
    for fn in ("host_mont_mul", "host_fq_inv", "host_g2_on_curve", "host_fq12_mul",
               "host_msm_affine", "host_msm_fixed", "host_g2_lines", "host_miller_mixed",
               "host_final_exp",
               "host_miller_product", "host_msm_pippenger", "host_pip_sort",
               "host_pip_buckets", "host_pip_reduce", "host_pip_combine", "host_sha256",
               "host_sha256_lead", "host_fr_inv",
               "host_plonk_lanes_a", "host_plonk_lanes_b", "host_plonk_lanes_a_ordered",
               "host_plonk_lanes_b_ordered", "host_plonk_max_nb"):
        getattr(lib, fn).restype = _I
    return lib

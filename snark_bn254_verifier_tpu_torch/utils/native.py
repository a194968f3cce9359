"""ctypes loader for the native C++ host data-plane (csrc/host/bn254_host.cc).

The port's copy of the JAX package's utils/native.py. It builds the shared
library on demand with g++ into the package's git-ignored ``_build/``
directory, initializes it with the moduli from the oracle (single source of
truth), and exposes the batch packers. The build writes a temporary file
named for its process and moves it into place with ``os.replace``, so
several processes that load the library at once (test workers) never map
a half-written file. Every entry point has a pure-Python fallback, so the
framework works without a compiler; the native path just makes host-side
batch preparation fast at large batch sizes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..oracle import bn254 as bn

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "host" / "bn254_host.cc"
_SO = _PKG / "_build" / "libbn254host.so"

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _mod_limbs64(modulus: int):
    return (ctypes.c_uint64 * 4)(
        *[(modulus >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4)]
    )


def _build() -> None:
    """Compile the library if it is missing or older than its source."""
    if _SO.exists() and _SO.stat().st_mtime >= _SRC.stat().st_mtime:
        return
    _SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                   check=True, capture_output=True)
    os.replace(tmp, _SO)


def get_lib() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native library; None on failure."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    try:
        _build()
        lib = ctypes.CDLL(str(_SO))
        lib.bn254_host_init.argtypes = [
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.bn254_pack_batch.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.bn254_pack_batch.restype = ctypes.c_int
        lib.bn254_parse_groth16_batch.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_size_t,
        ] + [ctypes.POINTER(ctypes.c_uint32)] * 8 + [
            ctypes.POINTER(ctypes.c_uint8)
        ]
        lib.bn254_parse_groth16_batch.restype = ctypes.c_int
        lib.bn254_host_init(_mod_limbs64(bn.P), _mod_limbs64(bn.R))
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _lib = None
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def pack_be_batch(
    data: bytes, n: int, field: str = "fq", to_mont: bool = True, reduce: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """n 32-byte big-endian elements -> ((16, n) uint32 limbs, flags).

    flags[i] == 1 marks a non-canonical (>= modulus) input.
    Raises RuntimeError if the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = np.zeros((16, n), dtype=np.uint32)
    flags = np.zeros(n, dtype=np.uint8)
    rc = lib.bn254_pack_batch(
        data,
        n,
        0 if field == "fq" else 1,
        1 if to_mont else 0,
        1 if reduce else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc < 0:
        raise RuntimeError("native pack failed")
    return out, flags


def parse_groth16_batch(proofs: bytes, stride: int, b: int):
    """Batch-parse b raw Groth16 proofs (contiguous, fixed stride) into
    Montgomery limb tensors + validity flags. Returns a dict of (16, b)
    uint32 arrays: ar_x, ar_y, bs_x0, bs_x1, bs_y0, bs_y1, krs_x, krs_y,
    plus valid (b,) bool."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    outs = {k: np.zeros((16, b), dtype=np.uint32) for k in
            ("ar_x", "ar_y", "bs_x0", "bs_x1", "bs_y0", "bs_y1", "krs_x", "krs_y")}
    valid = np.zeros(b, dtype=np.uint8)
    rc = lib.bn254_parse_groth16_batch(
        proofs, stride, b,
        *[outs[k].ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)) for k in
          ("ar_x", "ar_y", "bs_x0", "bs_x1", "bs_y0", "bs_y1", "krs_x", "krs_y")],
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc < 0:
        raise RuntimeError("native parse failed")
    outs["valid"] = valid.astype(bool)
    return outs

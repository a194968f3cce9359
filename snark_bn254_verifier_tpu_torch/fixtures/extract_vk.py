"""Extract the SP1 PlonK verifying key embedded in the reference guest ELF.

The port's copy of the JAX package's fixtures/extract_vk.py, over the
port's oracle and serialization. The reference's zkVM guests embed their
verifying keys via
``include_bytes!("../../../../.sp1/circuits/v2.0.0/plonk_vk.bin")``
(reference ``examples/program/src/plonk.rs:7``), so the VK bytes sit in
the prebuilt RISC-V ELFs under ``examples/program/elf/``. Both shipped
ELFs are the PlonK guest, so the PlonK VK is recoverable and the Groth16
VK is not.

The scan looks for the gnark PlonK vk.WriteTo header
(``plonk/converter.rs:21-26``): a big-endian u64 domain size followed by a
canonical Fr ``size_inv`` with ``size * size_inv == 1 (mod r)`` and a
canonical Fr generator of order ``size``. On a hit it parses the whole VK
(every curve point through the on-curve checks) and writes the exact byte
span to the output path (by default the port's fixtures/plonk_vk.bin).

Usage:
    python -m snark_bn254_verifier_tpu_torch.fixtures.extract_vk \
        [elf_path] [out_path]
"""

from __future__ import annotations

import struct
import sys
from pathlib import Path

from ..oracle import bn254 as bn
from ..utils import serialization as ser

DEFAULT_ELF = "/root/reference/examples/program/elf/plonk"
DEFAULT_OUT = Path(__file__).resolve().parent / "plonk_vk.bin"


def find_vk_offsets(data: bytes):
    """Yield candidate offsets where a gnark PlonK VK header starts."""
    for off in range(0, len(data) - 112):
        (size,) = struct.unpack_from(">Q", data, off)
        # gnark circuit domains are powers of two and at least 2.
        if size < 2 or size > 1 << 40 or size & (size - 1):
            continue
        size_inv = int.from_bytes(data[off + 8 : off + 40], "big")
        if size_inv >= bn.R or size * size_inv % bn.R != 1:
            continue
        generator = int.from_bytes(data[off + 40 : off + 72], "big")
        if generator >= bn.R or pow(generator, size, bn.R) != 1:
            continue
        yield off


def vk_byte_length(data: bytes, off: int) -> int:
    """Exact serialized VK length (plonk/converter.rs:18-86 layout)."""
    (num_qcp,) = struct.unpack_from(">I", data, off + 368)
    o = 372 + 32 * num_qcp + 160 + ser.GNARK_PRECOMPUTED_LINES_SIZE
    (num_cci,) = struct.unpack_from(">Q", data, off + o)
    return o + 8 + 8 * num_cci


def extract(elf_path: str = DEFAULT_ELF, out_path=DEFAULT_OUT) -> bytes:
    data = Path(elf_path).read_bytes()
    for off in find_vk_offsets(data):
        try:
            length = vk_byte_length(data, off)
            vk_bytes = data[off : off + length]
            ser.load_plonk_verifying_key_from_bytes(vk_bytes)  # full validation
        except Exception:
            continue
        print(f"found PlonK VK at offset {off}, {length} bytes")
        Path(out_path).write_bytes(vk_bytes)
        return vk_bytes
    raise SystemExit("no valid PlonK VK found in ELF")


if __name__ == "__main__":
    elf = sys.argv[1] if len(sys.argv) > 1 else DEFAULT_ELF
    out = sys.argv[2] if len(sys.argv) > 2 else DEFAULT_OUT
    extract(elf, out)

"""Parser for SP1 ``SP1ProofWithPublicValues`` wrapper binaries.

The reference's golden vectors (its examples/binaries/*.bin) are
bincode-serialized SP1 wrapper containers. The reference host driver decodes
them via the SP1 SDK (examples/script/src/main.rs:115-138); here we parse the
container directly: a u32 little-endian proof-enum tag (3 = Groth16,
2 = PlonK), then four u64-length-prefixed strings — two decimal public
inputs ``[vkey_hash, committed_values_digest]``, the gnark ``encoded_proof``
hex, and the ``raw_proof`` hex. The *raw_proof* is what the verifiers consume
(main.rs:130 uses ``proof.raw_proof``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List

PROOF_KIND_PLONK = 2
PROOF_KIND_GROTH16 = 3


@dataclass
class SP1WrappedProof:
    kind: str                 # "groth16" | "plonk"
    public_inputs: List[int]  # [vkey_hash, committed_values_digest] as ints
    encoded_proof: bytes
    raw_proof: bytes


def _read_string(buf: bytes, off: int):
    (n,) = struct.unpack_from("<Q", buf, off)
    off += 8
    return buf[off : off + n], off + n


def parse_sp1_wrapper(buf: bytes) -> SP1WrappedProof:
    (tag,) = struct.unpack_from("<I", buf, 0)
    if tag == PROOF_KIND_GROTH16:
        kind = "groth16"
    elif tag == PROOF_KIND_PLONK:
        kind = "plonk"
    else:
        raise ValueError(f"unsupported SP1 proof enum tag {tag}")
    off = 4
    pub0, off = _read_string(buf, off)
    pub1, off = _read_string(buf, off)
    encoded, off = _read_string(buf, off)
    raw, off = _read_string(buf, off)
    return SP1WrappedProof(
        kind=kind,
        public_inputs=[int(pub0.decode()), int(pub1.decode())],
        encoded_proof=bytes.fromhex(encoded.decode()),
        raw_proof=bytes.fromhex(raw.decode()),
    )


def load_sp1_wrapper(path: str) -> SP1WrappedProof:
    with open(path, "rb") as f:
        return parse_sp1_wrapper(f.read())

"""backend_pack_ms.single: the backend's host packing and copies to the
card (the program's span ``bn254.backend.pack``), mean ms a call
(``bn254.facade.verify``'s count) of the traced window. Layer: the
facades and the backend."""

FACADE, PACK = "bn254.facade.verify", "bn254.backend.pack"


def read(rec: dict, table=None):
    if "trace" not in rec:
        return None
    table = _table() if table is None else table
    if not table or FACADE not in table["spans"]:
        return None
    spans = table["spans"]
    pack = spans[PACK]["total_s"] if PACK in spans else 0.0
    return pack / spans[FACADE]["count"] * 1e3


def _table():
    """The program's span and counter table of the traced window, or None
    where the program records none."""
    try:
        from snark_bn254_verifier_tpu_torch.utils import profiling
    except ImportError:
        return None
    snapshot = getattr(profiling, "snapshot", None)
    return snapshot() if snapshot is not None else None


"""readbacks.single: the backend's copies from the card to the host (the
program's counter ``bn254.backend.reads``), each a wait for the card,
mean a call (``bn254.facade.verify``'s count) of the traced window.
Layer: the facades and the backend."""

FACADE, READS = "bn254.facade.verify", "bn254.backend.reads"


def read(rec: dict, table=None):
    if "trace" not in rec:
        return None
    table = _table() if table is None else table
    if not table or FACADE not in table["spans"]:
        return None
    return table["counters"].get(READS, 0) / table["spans"][FACADE]["count"]


def _table():
    """The program's span and counter table of the traced window, or None
    where the program records none."""
    try:
        from snark_bn254_verifier_tpu_torch.utils import profiling
    except ImportError:
        return None
    snapshot = getattr(profiling, "snapshot", None)
    return snapshot() if snapshot is not None else None


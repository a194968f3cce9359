"""slot_wait_ms.batch: the batch verifiers' wait for a free stream of
their ring (the program's span ``bn254.ring.wait``), mean ms a batch
(``bn254.batch.dispatch``'s count) of the traced window. Layer: async
dispatch."""

DISPATCH, WAIT = "bn254.batch.dispatch", "bn254.ring.wait"


def read(rec: dict, table=None):
    if "trace" not in rec:
        return None
    table = _table() if table is None else table
    if not table or DISPATCH not in table["spans"]:
        return None
    spans = table["spans"]
    wait = spans[WAIT]["total_s"] if WAIT in spans else 0.0
    return wait / spans[DISPATCH]["count"] * 1e3


def _table():
    """The program's span and counter table of the traced window, or None
    where the program records none."""
    try:
        from snark_bn254_verifier_tpu_torch.utils import profiling
    except ImportError:
        return None
    snapshot = getattr(profiling, "snapshot", None)
    return snapshot() if snapshot is not None else None


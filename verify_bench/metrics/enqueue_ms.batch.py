"""enqueue_ms.batch: the batch verifiers' host time queueing a batch on
the card, the program's spans ``bn254.batch.upload`` (staging into the
pinned buffer and queueing the copy) and ``bn254.batch.launch`` (every
kernel and glue op queued, the bools handed over), mean ms a batch
(``bn254.batch.dispatch``'s count) of the traced window. Layer: async
dispatch."""

DISPATCH = "bn254.batch.dispatch"
PARTS = ("bn254.batch.upload", "bn254.batch.launch")


def read(rec: dict, table=None):
    if "trace" not in rec:
        return None
    table = _table() if table is None else table
    if not table or DISPATCH not in table["spans"]:
        return None
    spans = table["spans"]
    return sum(spans[p]["total_s"] for p in PARTS if p in spans) / spans[DISPATCH]["count"] * 1e3


def _table():
    """The program's span and counter table of the traced window, or None
    where the program records none."""
    try:
        from snark_bn254_verifier_tpu_torch.utils import profiling
    except ImportError:
        return None
    snapshot = getattr(profiling, "snapshot", None)
    return snapshot() if snapshot is not None else None


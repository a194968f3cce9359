"""facade_ms.single: the facade's own host time in a call, the program's
span ``bn254.facade.verify`` less its children ``bn254.backend.*`` (so
its parse, the protocol's Python and the compare), mean ms a call
(``bn254.facade.verify``'s count) of the traced window. Layer: the
facades and the backend."""

FACADE = "bn254.facade.verify"


def read(rec: dict, table=None):
    if "trace" not in rec:
        return None
    table = _table() if table is None else table
    if not table or FACADE not in table["spans"]:
        return None
    spans = table["spans"]
    backend = sum(s["total_s"] for name, s in spans.items()
                  if name.startswith("bn254.backend.") and s["parent"] == FACADE)
    return (spans[FACADE]["total_s"] - backend) / spans[FACADE]["count"] * 1e3


def _table():
    """The program's span and counter table of the traced window, or None
    where the program records none."""
    try:
        from snark_bn254_verifier_tpu_torch.utils import profiling
    except ImportError:
        return None
    snapshot = getattr(profiling, "snapshot", None)
    return snapshot() if snapshot is not None else None


"""batch_p95_ms: the 95th percentile, over every batch of the window, of
the time from a batch's dispatch to its verdicts on the host (what a
relayer waiting for its block's verdicts feels)."""

import numpy as np


def read(rec: dict):
    return float(np.percentile(rec["latency_s"], 95)) * 1e3

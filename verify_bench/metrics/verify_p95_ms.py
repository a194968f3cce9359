"""verify_p95_ms: the 95th percentile latency of every call of the window."""

import numpy as np


def read(rec: dict):
    return float(np.percentile(rec["latency_s"], 95)) * 1e3

"""verify_p50_ms: the median latency of every call of the window."""

import numpy as np


def read(rec: dict):
    return float(np.percentile(rec["latency_s"], 50)) * 1e3

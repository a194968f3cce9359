"""dispatch_ms.batch: host ms inside ``verify_batch_async``, mean a batch
of the traced window (the benchmark's own span around the call: host
stages, the wait for a free stream of the ring, uploads and launches).
Layer: async dispatch."""

import numpy as np


def read(rec: dict):
    if not rec.get("dispatch_s"):
        return None
    return float(np.mean(rec["dispatch_s"])) * 1e3

"""host_stage_ms.batch: the batch verifier's host stages (parse and pack,
``last_stats.extra["host_s"]`` after each dispatch), mean ms a batch of
the traced window. Layer: the batch verifiers."""

import numpy as np


def read(rec: dict):
    if not rec.get("host_stage_s"):
        return None
    return float(np.mean(rec["host_stage_s"])) * 1e3

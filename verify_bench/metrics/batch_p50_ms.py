"""batch_p50_ms: the median, over every batch of the window, of the time
from a batch's dispatch to its verdicts on the host. In a closed loop it
is about the pipeline's depth times the period, so it shows a deeper
pipeline bought with latency even where the tail follows the host's
speed."""

import numpy as np


def read(rec: dict):
    return float(np.percentile(rec["latency_s"], 50)) * 1e3

"""device_idle_pct.batch: the share of the traced window in which no
operation ran on the card (one minus the union of the trace's device
intervals over the window), in the batch cells. Layer: the device."""


def read(rec: dict):
    t = rec.get("trace")
    if t is None:
        return None
    return 100.0 * (1.0 - t["busy_us"] / t["window_us"])

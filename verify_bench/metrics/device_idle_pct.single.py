"""device_idle_pct.single: the share of the traced window in which no
operation ran on the card, in the single cells. Layer: the device."""


def read(rec: dict):
    t = rec.get("trace")
    if t is None:
        return None
    return 100.0 * (1.0 - t["busy_us"] / t["window_us"])

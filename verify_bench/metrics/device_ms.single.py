"""device_ms.single: the union of the kernels' intervals inside a call,
mean ms a call of the traced window. Layer: the kernels."""


def read(rec: dict):
    t = rec.get("trace")
    if t is None or not t["calls"]:
        return None
    return sum(k for _, k, _ in t["calls"]) / len(t["calls"]) / 1e3

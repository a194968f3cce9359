"""host_ms.single: a call's latency less the time inside it in which an
operation ran on the card, mean ms a call of the traced window (the
facade's Python, the backend's packing and its host round trips).
Layer: the facades and the backend."""


def read(rec: dict):
    t = rec.get("trace")
    if t is None or not t["calls"]:
        return None
    return sum(d - busy for busy, _, d in t["calls"]) / len(t["calls"]) / 1e3

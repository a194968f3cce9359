"""proofs_per_s: every proof verdicted in the window (valid and invalid,
every lane of every batch) over the window's time, from the first
dispatch to the last batch's verdicts on the host."""


def read(rec: dict):
    return rec["lanes"] / rec["window_s"]

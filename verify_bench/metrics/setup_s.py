"""setup_s: seconds from the process's start to the window's: imports, the
kernels' build (first run of a checkout) and load, the pool's
generation, the verifier's construction and the warm-up calls."""


def read(rec: dict):
    return rec["setup_s"]

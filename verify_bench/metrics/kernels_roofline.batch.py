"""kernels_roofline.batch: the kernels' share of the card's multiply-add
peak: the proofs verdicted in the traced window times the
configuration's frozen products a proof (its ``products_per_proof``)
times 264 multiply-adds a product, over the union of the trace's kernel
intervals times 64 x 132 x 1.98e9 multiply-adds/s (verify_bench/peaks.py).
The count is of the work the algorithm needs, whichever kernels do it.
Layer: the kernels."""

from verify_bench import peaks


def read(rec: dict):
    t = rec.get("trace")
    if t is None or t["kernel_us"] <= 0:
        return None
    imads = rec["lanes"] * rec["products_per_proof"] * peaks.IMAD_PER_PRODUCT
    return 100.0 * imads / (t["kernel_us"] * 1e-6 * peaks.IMAD_PER_S)

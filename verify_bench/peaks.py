"""The card's peaks that the benchmark's roofline shares divide by.

NVIDIA H100 SXM (the data sheet and the CUDA Programming Guide's
throughput table for compute capability 9.0): 64 32-bit integer
multiply-adds a clock per SM, 132 SMs, 1.98 GHz boost. One Montgomery
product over BN254's 254-bit field on 8 x 32-bit limbs (CIOS: 64 a_i b_j
and 64 m p_j wide products, each a low and a high multiply-add, and 8
m = t0 n0' products) is 264 multiply-adds. These are frozen here, apart
from the program's own copy (utils/roofline.py), so that a change to the
program cannot move the yardstick.
"""

IMAD_PER_S = 64 * 132 * 1.98e9
IMAD_PER_PRODUCT = 2 * (64 + 64) + 8

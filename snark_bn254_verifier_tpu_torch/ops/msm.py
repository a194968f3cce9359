"""Large multi-scalar multiplication, the bucket (Pippenger) MSM, kernel K6;
and the fixed-base MSM's window tables and plain twins (kernel msm_fixed).

The counterpart of snark_bn254_verifier_tpu/ops/msm.py: ``_digits`` (:37
there), ``msm_pippenger`` (:59), ``PIPPENGER_THRESHOLD`` (:165),
``msm_pippenger_batched`` (:168) and ``msm_best`` (:176). The JAX code is
XLA (a segmented associative scan), with no Pallas kernel. Here the work
is CUDA kernel K6 (csrc/pippenger.cuh, wrappers ops/pairing_cuda.py::
msm_pippenger and its two halves), written by hand where the JAX package
had none, and its plain twin ``pippenger_plain``.

Every function takes the layout of K2 (ops/pairing_cuda.py::msm_affine):
points (x (N,16,B), y (N,16,B), inf (N,B)) in affine Montgomery limbs and
scalars (N,16,B) in canonical Fr limbs, B independent MSMs side by side.
Where the JAX functions return Jacobian points (and its ``msm_pippenger``
takes one MSM), these return the affine sum (x (16,B), y (16,B), inf (B,))
with infinity as (0, 0, True), limb-equal to K2's and the oracle's: the
affine point is unique.

Per lane, with W = ceil(256 / c) windows of c bits:
  1. the scalars' digits (``_digits``); a point at infinity takes digit 0,
     and digit 0 goes to no bucket;
  2. per (lane, window) row the points sorted by digit, and where each
     digit's run starts (``bucket_order``; on the card a counting sort in
     K6);
  3. the bucket sums B_j and each window's sum_j j * B_j: the window sums
     (``window_sums_plain``), (B, W, 24) int32 words, a Jacobian point in
     8 32-bit words a coordinate as K6 keeps it;
  4. Horner over the windows, high first: acc = 2^c * acc + window, after
     adding up k sets of window sums window by window (k > 1: the ranks of
     parallel/sharded.py::sharded_msm), then the affine form
     (``combine_plain``).

The fixed-base MSM takes points that every lane shares, a VK's, through
their window table: for point j, window w of ``FIXED_WINDOW`` = 8 bits
and digit d = 1 .. 255 the affine entry d * 2^(8 w) * P_j, as (n, 32,
255, 16) int32 words (``to_words`` of (x, y); all zero at infinity),
built once per VK (ops/pairing_cuda.py::fixed_base_table; its plain twin
``fixed_table_plain``), and only for at most ``FIXED_MAX_POINTS`` points
(``use_fixed_table``). A lane's sum is then one addition of an entry per
nonzero digit, with no doubling (``msm_fixed_plain``, the plain twin of
kernel msm_fixed).
"""

from __future__ import annotations

import torch

from ..oracle import bn254 as bn
from . import curve as C
from . import field as F
from . import pairing_cuda as PC  # K6's wrapper calls back into this module's glue
from .limbs import LIMB_BITS, NUM_LIMBS

G1 = C.G1_OPS
G1_WORDS = 24  # a Jacobian point in the kernels' 32-bit words (to_words)

# msm_best's switch by points n and lanes B, from both kernels timed on an
# H100 (chip_smoke.py's SWITCH_SHAPES; PERF.md). K2 takes one pass of about
# 3.4 ms per 16 points, whatever B up to 1024; K6 about 1.6-2.3 ms at B = 1,
# 2.5-3.2 at B = 32 and 39-62 at B = 1024, its per-(lane, window) reduction
# growing with B. So K6 from 16 points where B <= 4 n: at B = 1 and 32 from
# 16 points, at B = 1024 from 256 (53.1 ms each there; K2 13.3 ms at 64
# points, K6 61.8 against K2's 213.6 at 1024). The JAX package switches at 64
# points (its ops/msm.py:165). The protocols' MSMs have at most about 20
# points, so only a Groth16 VK with 15 or more public inputs reaches K6.
PIPPENGER_THRESHOLD = 16
PIPPENGER_LANES_PER_POINT = 4


def use_pippenger(n: int, b: int) -> bool:
    """msm_best's rule: K6 for n points over b lanes, else K2."""
    return n >= PIPPENGER_THRESHOLD and b <= PIPPENGER_LANES_PER_POINT * n


def windows(c: int) -> int:
    """Windows of ``c`` bits that cover a 256-bit scalar. A digit spans at
    most two 16-bit limbs, so c is 1..16."""
    if not 1 <= c <= 16:
        raise ValueError(f"Pippenger window width c={c} unsupported (need 1..16)")
    return -(-(LIMB_BITS * NUM_LIMBS) // c)


def _digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """(N, 16, B) canonical Fr limbs -> (W, N, B) int64 digits, window 0
    the lowest."""
    w = windows(c)
    s = scalars.to(torch.int64)
    out = []
    for win in range(w):
        limb, off = divmod(c * win, LIMB_BITS)
        d = s[:, limb] >> off
        if LIMB_BITS - off < c and limb + 1 < NUM_LIMBS:
            d = d | (s[:, limb + 1] << (LIMB_BITS - off))
        out.append(d & ((1 << c) - 1))
    return torch.stack(out)


def bucket_order(inf: torch.Tensor, scalars: torch.Tensor, c: int):
    """Per (lane, window) row: (digits, order, starts) with the row's
    digits sorted (B, W, N), the point indices in that order (B, W, N)
    and the start of each digit's run (B, W, 2^c + 1), so the points of
    bucket j of a row are order[row][starts[row][j]:starts[row][j + 1]].
    A point at infinity takes digit 0. The plain version (a stable sort)
    of K6's counting sort, whose order inside a bucket may differ."""
    d = _digits(scalars, c).masked_fill(inf.unsqueeze(0), 0)
    digits, order = torch.sort(d.permute(2, 0, 1).contiguous(), dim=-1, stable=True)
    bounds = torch.arange((1 << c) + 1, dtype=digits.dtype, device=digits.device)
    starts = torch.searchsorted(digits.contiguous(),
                                bounds.expand(digits.shape[:2] + bounds.shape).contiguous())
    return digits, order, starts


def _take(p, idx):
    return tuple(t[:, idx] for t in p)


def _halves(p):
    """Even and odd entries of the last axis of a point's coordinates."""
    return tuple(t[..., 0::2] for t in p), tuple(t[..., 1::2] for t in p)


def to_words(p) -> torch.Tensor:
    """A point's coordinates, a Jacobian (X, Y, Z) or an affine (x, y),
    each (16, *batch) 16-bit limbs, as the kernels keep them: (*batch, 24)
    or (*batch, 16) int32, coordinate i's word k at 8 i + k, limbs 2k and
    2k + 1 (lo | hi << 16; above 2^31 read as negative)."""
    t = torch.stack([v.to(torch.int64) for v in p])  # (coordinates, 16, *batch)
    w = t[:, 0::2] | (t[:, 1::2] << LIMB_BITS)
    w = torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)
    return w.reshape((-1,) + w.shape[2:]).movedim(0, -1).contiguous()


def from_words(w: torch.Tensor):
    """``to_words``'s inverse: (*batch, 24) or (*batch, 16) int32 -> the
    coordinates, each (16, *batch) int64 limbs."""
    v = (w.to(torch.int64) & 0xFFFFFFFF).movedim(-1, 0)
    v = v.reshape((-1, NUM_LIMBS // 2) + v.shape[1:])
    limbs = torch.stack([v & 0xFFFF, v >> LIMB_BITS], dim=2)
    return tuple(limbs.reshape((-1, NUM_LIMBS) + v.shape[2:]))


def window_sums_plain(points, scalars, c: int = 8) -> torch.Tensor:
    """Plain twin of K6's stages 1-5: each lane's window sums
    sum_j j * B_j, (B, W, 24) int32 words (``to_words``).

    Vectorised over every lane and window at once, with trees in place of
    the kernel's per-thread chains: the points of a bucket are summed in
    a tree over their rank in the bucket's run; the window sum
    sum_j j * B_j in a tree over the buckets, where a block of buckets
    [lo, lo + L) carries R = sum B_j and S = sum (j - lo) B_j and two
    neighbours merge as R_l + R_r and S_l + S_r + L * R_r (L a power of
    two: log2 L doublings). A Jacobian point has many forms, so these
    words need not equal the kernel's; their affine forms do."""
    x, y, inf = points
    n, _, b = x.shape
    w, nb = windows(c), 1 << c
    digits, order, _ = bucket_order(inf.to(torch.bool), scalars, c)
    rows = torch.arange(b * w, device=x.device).view(b, w, 1)
    lane = torch.arange(b, device=x.device).view(b, 1, 1)
    keep = (digits != 0).reshape(-1)
    key = (rows * nb + digits).reshape(-1)[keep]            # nondecreasing
    src = (lane * n + order).reshape(-1)[keep]              # into (16, B * N)
    xs = x.to(torch.int64).permute(1, 2, 0).reshape(NUM_LIMBS, b * n)
    ys = y.to(torch.int64).permute(1, 2, 0).reshape(NUM_LIMBS, b * n)
    aff = (xs[:, src], ys[:, src])
    p = (aff[0], aff[1], G1.one(aff[0]))                    # Jacobian, Z = 1

    # bucket sums: element k of a run adds element k + step where k is a
    # multiple of 2 step; the run's sum ends at its head
    first = torch.searchsorted(key, key)
    length = torch.searchsorted(key, key, right=True) - first
    rank = torch.arange(key.numel(), device=x.device) - first
    step = 1
    while key.numel() and step < int(length.max()):
        idx = torch.nonzero((rank % (2 * step) == 0) & (rank + step < length)).flatten()
        s = C.jacobian_add(G1, _take(p, idx), _take(p, idx + step))
        p = tuple(t.index_copy(1, idx, v) for t, v in zip(p, s))
        step *= 2
    head = rank == 0
    like = xs.new_zeros((NUM_LIMBS, b * w * nb))
    bucket = list(C.inf_point(G1, like))
    for i in range(3):
        bucket[i] = bucket[i].clone()
        bucket[i][:, key[head]] = p[i][:, head]
    bucket = tuple(t.view(NUM_LIMBS, b * w, nb) for t in bucket)

    # window sums: the (R, S) tree over the bucket axis; blocks of one
    # bucket have S = 0, so the first merge gives S = R_r
    left, right = _halves(bucket)
    r_sum, s_sum = C.jacobian_add(G1, left, right), right
    span = 2
    while r_sum[0].shape[-1] > 1:
        (rl, rr), (sl, sr) = _halves(r_sum), _halves(s_sum)
        scaled = rr
        for _ in range(span.bit_length() - 1):
            scaled = C.jacobian_double(G1, scaled)
        s_sum = C.jacobian_add(G1, C.jacobian_add(G1, sl, sr), scaled)
        r_sum = C.jacobian_add(G1, rl, rr)
        span *= 2
    return to_words(tuple(t[..., 0].reshape(NUM_LIMBS, b, w) for t in s_sum))


def combine_plain(wsums: torch.Tensor, c: int = 8):
    """Plain twin of K6's combine: k sets of window sums wsums (k, B, W,
    24) int32 words added window by window, Horner over the windows, high
    first (c doublings and an add a window), and the affine sum."""
    w = windows(c)
    sets = from_words(wsums)  # each coordinate (16, k, B, W)
    win_sum = tuple(t[:, 0] for t in sets)
    for i in range(1, wsums.shape[0]):
        win_sum = C.jacobian_add(G1, win_sum, tuple(t[:, i] for t in sets))
    acc = tuple(t[..., w - 1] for t in win_sum)
    for win in range(w - 2, -1, -1):
        for _ in range(c):
            acc = C.jacobian_double(G1, acc)
        acc = C.jacobian_add(G1, acc, tuple(t[..., win] for t in win_sum))
    ax, ay, ainf = C.to_affine(G1, acc)
    return ax.to(torch.int32), ay.to(torch.int32), ainf


def pippenger_plain(points, scalars, c: int = 8):
    """Plain twin of kernel K6: the bucket MSM per lane, in affine form,
    ``combine_plain`` of one set of ``window_sums_plain``."""
    return combine_plain(window_sums_plain(points, scalars, c).unsqueeze(0), c)


def msm_pippenger(points, scalars, c: int = 8):
    """The bucket MSM per lane (kernel K6 on CUDA tensors, its plain twin
    on CPU tensors), in affine form; c is the window width, 1..16."""
    return PC.msm_pippenger(points, scalars, c)


# The JAX package's batched name (a vmap of its one-MSM msm_pippenger);
# the port's msm_pippenger takes a batch already.
msm_pippenger_batched = msm_pippenger


def msm_best(points, scalars, c: int = 8):
    """The MSM per lane by size, in affine form: Pippenger (K6) where
    ``use_pippenger`` says (16 points or more, and no more than 4 lanes a
    point), else K2's windowed Straus pass."""
    if use_pippenger(points[0].shape[0], points[0].shape[-1]):
        return PC.msm_pippenger(points, scalars, c)
    return PC.msm_affine(points, scalars)


# Bits a window of the fixed-base tables (csrc/msm_fixed.cuh's
# FX_WINDOW), fixed by measurement on an H100 against 4 and 6 bits
# (PERF.md): the widest gives the fewest additions a lane, and its table,
# 0.5 MB a point, still stays in L2.
FIXED_WINDOW = 8
FIXED_WINDOWS = windows(FIXED_WINDOW)  # 32 windows cover a 256-bit scalar
# Entries a window: every digit, the top window's too, so any 256-bit
# scalar reads inside the table.
FIXED_DIGITS = (1 << FIXED_WINDOW) - 1
ENTRY_WORDS = 16  # an affine table entry: x, then y, 8 words each
FIXED_TEAM = 16  # threads a lane of kernel msm_fixed (csrc/msm_fixed.cuh's FX_TEAM)
# Most points that get a table: 32 points' tables, 16.7 MB, a third of the
# H100's 50 MB L2, built by about 0.6 s of K2 (PERF.md). Past it a VK's
# MSM stays with msm_best, so a VK of hundreds of inputs holds no table of
# hundreds of MB.
FIXED_MAX_POINTS = 32


def use_fixed_table(n: int) -> bool:
    """Whether n fixed points (a VK's) get a window table and the
    fixed-base MSM, or keep msm_best."""
    return 1 <= n <= FIXED_MAX_POINTS


def window_scalars() -> list:
    """The scalar of each entry of a point's table, window-major:
    d * 2^(8 w) mod r for window w and digit d = 1 .. 255."""
    return [(d << (FIXED_WINDOW * w)) % bn.R for w in range(FIXED_WINDOWS)
            for d in range(1, FIXED_DIGITS + 1)]


def _batch_inverse(z: torch.Tensor) -> torch.Tensor:
    """The Fq inverses of (16, N) nonzero Montgomery values by one
    inversion (Montgomery's trick, a level of the product tree at a time):
    the products of neighbours up to the root, its inverse, and back down,
    each child's inverse its parent's times its sibling. A level of odd
    length is padded with one. (A Fermat inversion a value, as
    ``curve.to_affine`` takes, would cost the CPU a minute a table.)"""
    levels = [z]
    while levels[-1].shape[-1] > 1:
        t = levels[-1]
        if t.shape[-1] % 2:
            levels[-1] = t = torch.cat([t, G1.one(t[:, :1])], dim=1)
        levels.append(F.fq_mul(t[:, 0::2], t[:, 1::2]))
    inv = F.fq_inv(levels[-1])
    for t in reversed(levels[:-1]):
        inv = inv[:, :t.shape[-1] // 2]
        inv = torch.stack([F.fq_mul(inv, t[:, 1::2]), F.fq_mul(inv, t[:, 0::2])], dim=-1)
        inv = inv.reshape(NUM_LIMBS, -1)
    return inv[:, :z.shape[-1]]


def fixed_table_plain(points) -> torch.Tensor:
    """Plain twin of ops/pairing_cuda.py::fixed_base_table: the window
    table of n fixed points (x (16, n), y (16, n), inf (n,), affine
    Montgomery limbs), (n, 32, 255, 16) int32 words. The chain 2^i P of
    every point by doublings; then, all windows at once, digits 2^L ..
    2^(L+1) - 1 as 2^(8 w + L) P plus digits 1 .. 2^L - 1, a level of
    additions for each bit L of a digit; then every entry affine by one
    inversion."""
    x, y, inf = points
    n, c, nwin = x.shape[-1], FIXED_WINDOW, FIXED_WINDOWS
    p = C.to_jacobian(G1, (x.to(torch.int64), y.to(torch.int64), inf.to(torch.bool)))
    chain = [p]
    for _ in range(c * nwin - 1):
        chain.append(C.jacobian_double(G1, chain[-1]))
    # 2^(8 w + L) P at [:, w, L], (16, W, 8, n)
    pw = tuple(torch.stack([q[i] for q in chain], dim=1).view(NUM_LIMBS, nwin, c, n)
               for i in range(3))
    ent = tuple(t[:, :, :1] for t in pw)  # digit 1
    for level in range(1, c):
        base = tuple(t[:, :, level:level + 1] for t in pw)
        more = C.jacobian_add(G1, tuple(b.expand_as(e) for b, e in zip(base, ent)), ent)
        ent = tuple(torch.cat([e, b, m], dim=2) for e, b, m in zip(ent, base, more))
    X, Y, Z = (t.reshape(NUM_LIMBS, -1) for t in ent)
    at_inf = F.is_zero(Z)
    zinv = _batch_inverse(F.select(at_inf, G1.one(Z), Z))
    zinv2 = F.fq_sq(zinv)
    ax, zinv3 = G1.mul_many([(X, zinv2), (zinv, zinv2)])
    ay = F.fq_mul(Y, zinv3)
    zero = torch.zeros_like(ax)
    words = to_words((F.select(at_inf, zero, ax), F.select(at_inf, zero, ay)))
    return words.view(nwin, FIXED_DIGITS, n, ENTRY_WORDS).permute(2, 0, 1, 3).contiguous()


def msm_fixed_plain(table: torch.Tensor, scalars: torch.Tensor):
    """Plain twin of kernel msm_fixed: sum_j scalars[j] * P_j per lane
    from the points' window table (n, 32, 255, 16) and scalars (n, 16, B)
    canonical Fr limbs, in affine form (x (16, B) int32, y, inf (B,)
    bool). As the kernel's team sums them: the (point, window) pairs p =
    32 j + w, thread r's sum the mixed adds of the entries of pairs r, r +
    FIXED_TEAM, ... (the one each digit picks; infinity for digit 0),
    then the threads' sums in a tree, then the affine form."""
    n = table.shape[0]
    pairs = n * FIXED_WINDOWS
    d = _digits(scalars, FIXED_WINDOW).permute(2, 1, 0).reshape(scalars.shape[-1], pairs)
    rows = torch.arange(pairs, device=d.device) * FIXED_DIGITS  # pair p's first entry
    words = table.reshape(-1, ENTRY_WORDS)[rows + (d - 1).clamp(min=0)]  # (B, pairs, 16)
    words = words.masked_fill((d == 0).unsqueeze(-1), 0)
    steps = -(-pairs // FIXED_TEAM)
    words = torch.cat([words, words.new_zeros((d.shape[0], steps * FIXED_TEAM - pairs,
                                               ENTRY_WORDS))], dim=1)
    ex, ey = from_words(words.view(d.shape[0], steps, FIXED_TEAM, ENTRY_WORDS))
    acc = C.inf_point(G1, ex[:, :, 0])  # (16, B, FIXED_TEAM)
    for t in range(steps):
        x, y = ex[:, :, t], ey[:, :, t]
        acc = C.jacobian_add_mixed(G1, acc, (x, y, F.is_zero(x) & F.is_zero(y)))
    while acc[0].shape[-1] > 1:
        acc = C.jacobian_add(G1, *_halves(acc))
    ax, ay, ainf = C.to_affine(G1, tuple(t[..., 0] for t in acc))
    return ax.to(torch.int32), ay.to(torch.int32), ainf

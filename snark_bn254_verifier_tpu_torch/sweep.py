"""Time variants of the team kernels and K6 against the built ones, on one card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 -m snark_bn254_verifier_tpu_torch.sweep [--only NAME ...]

Each variant in ``VARIANTS`` is the repository's kernel sources with a few
text edits (a team shape, a code change): the tool copies csrc/ into
``_build/sweep/<variant>/``, applies the edits, compiles the units the
variant changes (one ``nvcc`` each, all at once) and links them with the
main build's objects of the other units into a library of its own, all
by ops/_build.py's own compile and link steps. It then runs the
kernels' wrappers with their launches sent to that library, on the
shapes of the main paths (batch one and batch 1024), holds each output
limb-equal to the main build's (which chip_smoke.py holds to the plain
twins and the oracle), and times the variants in turns, by CUDA events
over warm launches. It prints the card's name and power limit and one
JSON line per variant. The team shapes stay constants of the headers;
this tool only rewrites copies of them.
"""

from __future__ import annotations

import argparse
import json
import random
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from .fixtures.msm_lanes import trapdoor_msm
from .models.packing import pack_g1, pack_g2, pack_msm, pair_major
from .ops import _build
from .ops import lines as LN
from .ops import pairing_cuda as PC
from .ops.limbs import FR
from .oracle import bn254 as bn

SWEEP_DIR = _build.BUILD_DIR / "sweep"
K6_BULK = ("pippenger.cu", ("-DBN_PIP_COMBINE=0",))  # K6's stages 1-5 (pippenger.cu)
KERNEL_UNIT = {"msm_affine": _build.team_unit(2), "miller_mixed": _build.team_unit(3),
               "final_exp": _build.team_unit(4), "miller_product": _build.team_unit(5),
               "msm_pippenger": K6_BULK}
T2, T3, T4, T5 = (_build.team_unit(k) for k in (2, 3, 4, 5))

# (name, units rebuilt, {file: [(old, new)]}, exact); "base" is the main
# build, whose shapes and forms were kept. An ablation (exact=False) drops
# work to show its share of the time; it is timed, not compared.
_ROLLED = "#if BN_TEAM_KERNEL == 2 || BN_TEAM_KERNEL == 5"
# K2's kept form: each thread a point with its own windowed chain, then a
# tree of the threads' sums.
_K2_OWN_CHAINS = """\
  g1j acc;
  g1_inf(acc);
#pragma unroll 1
  for (int pt = r; pt < npts; pt += MSM_TEAM) {
    fp s;
    g1j sum;
    msm_table(tbl, s, px, py, pinf, sc, pt, n, src);
    msm_pass(sum, tbl, s);
    g1_add(acc, acc, sum);
  }
  part[r] = acc;
  TEAM_SYNC();
#pragma unroll 1
  for (int step = 1; step < MSM_TEAM; step *= 2) {
    if (r % (2 * step) == 0) {
      g1j a = part[r];
      const g1j b = part[r + step];
      g1_add(a, a, b);
      part[r] = a;
    }
    TEAM_SYNC();
  }
"""
# The other candidate: one shared chain. Thread r holds point r's table
# (npts <= MSM_TEAM only); in each window the threads' entries are summed in
# a tree, then rank 0 doubles four times and adds the window's sum.
_K2_SHARED_CHAIN = """\
  const bool mine = r < npts;
  fp s;
  msm_table(tbl, s, px, py, pinf, sc, mine ? r : 0, n, src);
  int span = 1;
  while (span < npts) span *= 2;
  g1j acc;
  g1_inf(acc);
#pragma unroll 1
  for (int win = 256 / MSM_WINDOW - 1; win >= 0; --win) {
    const int bit = win * MSM_WINDOW;
    const uint32_t dig = (s.w[bit >> 5] >> (bit & 31)) & (MSM_TABLE - 1);
    part[r] = tbl[mine ? dig : 0];
    TEAM_SYNC();
#pragma unroll 1
    for (int step = 1; step < span; step *= 2) {
      if (r % (2 * step) == 0) {
        g1j a = part[r];
        const g1j b = part[r + step];
        g1_add(a, a, b);
        part[r] = a;
      }
      TEAM_SYNC();
    }
    if (r == 0) {
#pragma unroll 1
      for (int k = 0; k < MSM_WINDOW; ++k) g1_dbl(acc, acc);
      const g1j q = part[0];
      g1_add(acc, acc, q);
    }
    TEAM_SYNC();
  }
  if (r == 0) part[0] = acc;
  TEAM_SYNC();
"""
VARIANTS = [
    ("K5 12x4x1", (T5,), {"team.cuh": [("#define MP_TEAM 18", "#define MP_TEAM 12")]}, True),
    ("K5 18x4x2", (T5,), {"team.cuh": [("#define MP_LPB 1", "#define MP_LPB 2")]}, True),
    ("K2 16x1", (T2,), {"msm.cuh": [("#define MSM_LPB 2", "#define MSM_LPB 1")]}, True),
    ("K2 8x4", (T2,), {"msm.cuh": [("#define MSM_TEAM 16", "#define MSM_TEAM 8"),
                                   ("#define MSM_LPB 2", "#define MSM_LPB 4")]}, True),
    ("K2 Fermat inverse", (T2,), {"curve.cuh": [("fq_inv_binary(zinv, p.z);",
                                                 "fq_inv(zinv, p.z);")]}, True),
    ("K2 K5 unrolled CIOS", (T2, T5), {"team_kernels.cu": [(_ROLLED, "#if 0")]}, True),
    ("K3 K4 rolled CIOS", (T3, T4), {"team_kernels.cu": [(_ROLLED, "#if 1")]}, True),
    ("K5 no f squaring", (T5,), {"team.cuh": [
        ("    team_mul(t, f, f, f, scratch);\n    if (has_var)", "    if (has_var)")]}, False),
    ("K5 no line products", (T5,), {"team.cuh": [
        ("    team_mul_line(t, f, scratch, l00, l10, l11);\n  }\n  for (int j = 0; j < nf",
         "  }\n  for (int j = 0; j < nf")]}, False),
    ("K5 no G2 steps", (T5,), {"team.cuh": [
        ("    if (has_var) team_dbl_step(t, G);", ""),
        ("    if (has_var) team_add_step(t, G, G_XQ, G_YQ);", "")]}, False),
    ("K2 no doublings", (T2,), {"msm.cuh": [
        ("    for (int k = 0; k < MSM_WINDOW; ++k) g1_dbl(acc, acc);", "")]}, False),
    ("K2 no window adds", (T2,), {"msm.cuh": [("    g1_add(acc, acc, q);\n  }", "  }")]}, False),
    ("K2 shared chain", (T2,), {"msm.cuh": [(_K2_OWN_CHAINS, _K2_SHARED_CHAIN)]}, True),
    # K6's stages 1-5: the unrolled product; blocks of 64 threads for the
    # per-thread stages; the reduction's blocks always narrow, always wide
    ("K6 unrolled CIOS", (K6_BULK,), {"pippenger.cu": [
        ("#else\n#define BN_ROLLED_CIOS 1", "#else\n#define BN_ROLLED_CIOS 0")]}, True),
    ("K6 blocks of 64", (K6_BULK,), {"pippenger.cu": [
        ("#define PIP_BLOCK 128", "#define PIP_BLOCK 64")]}, True),
    ("K6 narrow reduction", (K6_BULK,), {"pippenger.cuh": [
        ("#define PIP_WIDE_ROWS 1024", "#define PIP_WIDE_ROWS 1")]}, True),
    ("K6 wide reduction", (K6_BULK,), {"pippenger.cuh": [
        ("#define PIP_WIDE_ROWS 1024", "#define PIP_WIDE_ROWS (1ll << 40)")]}, True),
]


def build_variant(name: str, kernels, edits, nvcc: str):
    """Start the compilers of one variant's units (those of ``kernels``),
    by _build's own commands; returns (name, root, units, processes)."""
    root = SWEEP_DIR / name.replace(" ", "_")
    if root.exists():
        shutil.rmtree(root)
    src = root / "csrc"
    shutil.copytree(_build.CSRC, src)
    for fname, subs in edits.items():
        text = (src / fname).read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: edit not found in {fname}")
            text = text.replace(old, new)
        (src / fname).write_text(text)
    units = list(kernels)
    return name, root, units, _build.start_units(nvcc, src, root / "obj", units)


def link_variant(name, root, units, procs, nvcc: str):
    """Wait for a variant's units, link them with the main build's objects
    of the other units of _build.UNITS, and bind the library; returns
    (lib, ptxas lines)."""
    _, out = _build.finish_units(procs)
    log = [ln.strip() for ln in out.splitlines() if "Used" in ln or "stack frame" in ln]
    objs = [_build.unit_object(root / "obj" if u in units else _build.OBJ_DIR, u)
            for u in _build.UNITS]
    lib_path = root / "lib.so"
    _build.link_library(nvcc, objs, lib_path)
    lib = _build.bind_kernels(lib_path)
    _build.check(lib, lib.bn_init(_build.STACK_BYTES), "bn_init")
    return lib, log


def variant_launch(lib):
    """A stand-in for field_cuda.launch that sends launches to ``lib``."""

    def launch(dev, entry, *args):
        with torch.cuda.device(dev):
            code = getattr(lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
            _build.check(lib, code, entry)

    return launch


def cases(seed: int = 0):
    """(kernel, label, wrapper call) on the main paths' shapes."""
    dev = torch.device("cuda")
    rng = random.Random(seed)
    g1 = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(8)]
    g2 = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(4)]

    def on(arrays):
        return tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in arrays)

    def msm(n, b):
        packed = [pack_g1([g1[rng.randrange(8)] for _ in range(b)]) for _ in range(n)]
        pts = on([np.stack([p[i] for p in packed]) for i in range(3)])
        sc = on([np.stack([FR.pack([rng.randrange(bn.R) for _ in range(b)], mont=False)
                           for _ in range(n)])])[0]
        return lambda: PC.msm_affine(pts, sc)

    def pippenger(n, b):
        if b == 1:  # the bench's trapdoor points (fixtures/msm_lanes.py, seed 11)
            pts, scs, _ = trapdoor_msm(n, 11)
            packed, sc = pack_msm(pts, scs)
            P, S = on(packed), on([sc])[0]
        else:
            packed = [pack_g1([g1[rng.randrange(8)] for _ in range(b)]) for _ in range(n)]
            P = on([np.stack([p[i] for p in packed]) for i in range(3)])
            S = on([np.stack([FR.pack([rng.randrange(bn.R) for _ in range(b)], mont=False)
                              for _ in range(n)])])[0]
        return lambda: PC.msm_pippenger(P, S)

    def pairs(n, b):
        ps = [[g1[rng.randrange(8)] for _ in range(b)] for _ in range(n)]
        qs = [[g2[rng.randrange(4)] for _ in range(b)] for _ in range(n)]
        P, Q = on(pair_major(pack_g1, ps)), on(pair_major(pack_g2, qs))
        return lambda: PC.miller_product(P, Q)

    lines, tails = LN.tables_from_numpy([LN.g2_line_table(q) for q in g2[:2]], dev)
    b = 1024
    fixed = tuple(on(pack_g1([g1[rng.randrange(8)] for _ in range(b)])) for _ in range(2))
    vp, vq = on(pack_g1([g1[rng.randrange(8)] for _ in range(b)])), \
        on(pack_g2([g2[rng.randrange(4)] for _ in range(b)]))
    f = PC.miller_mixed(vp, vq, fixed, lines, tails)
    return [
        ("msm_affine", "B=1 n=11", msm(11, 1)),
        ("msm_affine", "B=1 n=1", msm(1, 1)),
        ("msm_affine", "B=1024 n=3", msm(3, b)),
        ("miller_product", "B=1 n=3", pairs(3, 1)),
        ("miller_product", "B=1 n=2", pairs(2, 1)),
        ("miller_product", "B=1024 n=3", pairs(3, b)),
        ("miller_mixed", "B=1024", lambda: PC.miller_mixed(vp, vq, fixed, lines, tails)),
        ("final_exp", "B=1", lambda: PC.final_exp(f[:, :, :1].contiguous())),
        ("final_exp", "B=1024", lambda: PC.final_exp(f)),
        ("msm_pippenger", "B=1 n=2^16", pippenger(1 << 16, 1)),
        ("msm_pippenger", "B=1024 n=64", pippenger(64, b)),
    ]


def time_ms(fn, iters: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flat(out):
    return torch.cat([t.reshape(-1).to(torch.int64) for t in out]) if isinstance(out, tuple) \
        else out.reshape(-1).to(torch.int64)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", help="variant names to build (default: all)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    main_lib = _build.load_kernels()
    nvcc = _build.find_nvcc()
    chosen = [v for v in VARIANTS if args.only is None or v[0] in args.only]
    started = [build_variant(name, units, edits, nvcc) for name, units, edits, _ in chosen]
    libs = {"base": (main_lib.lib, [])}
    for name, root, units, procs in started:
        libs[name] = link_variant(name, root, units, procs, nvcc)
    print(f"builds: {time.perf_counter() - t0:.1f} s ({len(chosen)} variants)")
    units = {name: set(u) for name, u, _, _ in chosen}
    units["base"] = set(KERNEL_UNIT.values())
    exact = {name: ex for name, _, _, ex in chosen}

    real_launch = PC.launch
    results = {name: {} for name in libs}
    try:
        for kernel, label, call in cases():
            PC.launch = real_launch
            want = flat(call())
            names = [n for n in libs if KERNEL_UNIT[kernel] in units[n]]
            for name in names:  # exact against the main build first
                PC.launch = variant_launch(libs[name][0])
                if exact.get(name, True) and not torch.equal(flat(call()), want):
                    raise RuntimeError(f"variant {name}: {kernel} {label} differs from the main build")
            times = {n: [] for n in names}
            for _ in range(args.rounds):  # in turns: a b c ... c b a
                for name in names + names[::-1]:
                    PC.launch = variant_launch(libs[name][0])
                    times[name].append(time_ms(call, args.iters))
            for name in names:
                results[name][f"{kernel} {label}"] = min(times[name])
            print(f"{kernel} {label}: " + ", ".join(
                f"{n} {min(times[n]):.3f}" for n in names) + " ms (best of turns)")
    finally:
        PC.launch = real_launch
    for name, (_, log) in libs.items():
        print(json.dumps({"variant": name, "exact": exact.get(name, True), "ms": results[name],
                          "ptxas": log}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The control of the comparison that decides ``correct``, and the faults
of the timed path, read through a cell's own set-up, window and check at
the cell's own size (its traffic file: pool, batch, invalid share).

The control is the plain reference put in the program's place with one
guarantee of the configuration broken (a non-canonical coordinate or
scalar reduced instead of refused); each fault (``standin.FAULTS``) is the
sound reference with the timed path broken underneath as a program at
fault would break it. Each has to come out not correct on every seed.

    python3 -m verify_bench.control --workload <name> --seeds <n> [<n> ...] \\
        [--seconds 2] [--workers 8] [--faults unchanged half dropped altered] [--sound]

Every pool item's verdict is computed before the window in ``--workers``
processes (a pure-Python pairing takes about 0.1 s), once a seed for each
reference, so the window compares as many verdicts a second as the
program's would. ``--sound`` also runs the reference unbroken, which has
to come out correct. Needs no GPU. Prints one JSON line a seed and
reading with its checks and the ``correct`` it came to; exits 1 where
any reading came to the other ``correct``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from . import run, standin
from .gen.pool import make_pool


def readings(args) -> list:
    """(name, canonical reference, fault, correct wanted) of each reading."""
    out = [("sound", True, None, True)] if args.sound else []
    out.append(("non-canonical accepted", False, None, False))
    return out + [(f"fault {f}", True, f, False) for f in args.faults]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--faults", nargs="*", default=[], choices=standin.FAULTS)
    ap.add_argument("--sound", action="store_true")
    args = ap.parse_args(argv)
    cell, cfg, traffic, metrics = run.load_cell(Path.cwd(), args.workload)
    wrong = 0
    for seed in args.seeds:
        t = time.perf_counter()
        pool = make_pool(cfg, traffic, seed)
        refs = {}
        for name, canonical, fault, want in readings(args):
            if canonical not in refs:
                refs[canonical] = standin.Reference(cfg, pool.vk, seed, canonical)
                refs[canonical].precompute(pool, args.workers)
            ref = refs[canonical]
            result = run.run_cell(
                cell, cfg, traffic, metrics, seed, args.seconds, False,
                system=lambda c, v, r=ref, f=fault: standin.stand_in(traffic["runner"], r, f),
                t_start=t)
            wrong += result["correct"] != want
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": name,
                              "correct": result["correct"], "attempted": result["attempted"],
                              "checks": result["checks"],
                              "seconds": time.perf_counter() - t}), flush=True)
            t = time.perf_counter()
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())

"""Weak scaling of the batched Groth16 path over processes, one device a
process.

The counterpart of the JAX package's tools/weak_scaling_child.py and of
the ``scaling`` config of its bench (bench.py:526-584), which measure a
CPU mesh of 1 to 8 virtual devices as a one-host proxy. Here a point is
N processes of a process group (parallel/sharded.py): one card a rank
over NCCL, or, where the caller asks for the CPU, one core a rank over
gloo. Each rank takes its slice of the lanes with ``shard_batch`` and
verifies them with ``Groth16BatchVerifier`` on its device, pipelined
through ``verify_batch_async`` as the bench's batch configs are (at most
two batches in flight), at a fixed batch per rank; the ranks meet at a
barrier before the timed loop and in an all-reduce of their valid counts
after it, so the rate is the slowest rank's.

The points are 1, 2, 4 and 8 ranks, as many as the machine has cards
(its cores, on the CPU). efficiency(N) = rate(N) / (N x rate(1));
efficiency_vs_core_ceiling divides by min(N, units) x rate(1) instead,
the units being the cards (so both agree) or the host's cores, so that a
host with fewer cores than ranks measures the sharding, not the
oversubscription.

    python3 -m snark_bn254_verifier_tpu_torch.weak_scaling [--per-rank B]
        [--iters K] [--ranks 1,2,4,8] [--device cuda|cpu]

prints the bench's ``weak_scaling_efficiency_8dev`` line. The batch per
rank is the bench's 1024 on the card. On the CPU it is PER_RANK_CPU (16),
not the JAX package's 64: the plain twins take tens of seconds a batch on
one core, and the bench's four points must fit its 900 s budget.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from .parallel.sharded import free_port

PER_RANK = 1024  # the bench's batch: one card's batch
PER_RANK_CPU = 16
JAX_PER_RANK = 64  # the JAX bench's per-device batch (bench.py:534)
RANKS = (1, 2, 4, 8)
PKG_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(rank: int, world: int, port: int, per_rank: int, iters: int, device: str) -> None:
    """One rank of a point; rank 0 prints the point as a JSON line."""
    import torch
    import torch.distributed as dist

    from .bench import pipelined
    from .fixtures.gen import gen_groth16_vector
    from .parallel.batch import Groth16BatchVerifier
    from .parallel.sharded import init_distributed, make_mesh, shard_batch

    # a core a rank on the CPU; on the card the host's cores shared out
    torch.set_num_threads(1 if device == "cpu" else max(1, (os.cpu_count() or 1) // world))
    init_distributed(init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
                     device=device)
    try:
        mesh = make_mesh(world, model_parallelism=1, device=device)
        total = per_rank * world
        lanes = shard_batch(torch.arange(total), mesh).tolist()
        vec = gen_groth16_vector(0, num_inputs=2)
        proofs, inputs = [vec.proof] * len(lanes), [vec.public_inputs] * len(lanes)
        ver = Groth16BatchVerifier(vec.vk, device=device)
        t0 = time.perf_counter()
        if not ver.verify_batch(proofs, inputs).all():
            raise RuntimeError(f"rank {rank}: the warm-up batch did not verify")
        warm_s = time.perf_counter() - t0
        dist.barrier()
        t0 = time.perf_counter()
        pipelined([(lambda: ver.verify_batch_async(proofs, inputs), ver)], iters)
        count = torch.tensor([len(lanes) * iters], device=device)
        dist.all_reduce(count)
        verified = int(count.item())
        elapsed = time.perf_counter() - t0
        if verified != total * iters:
            raise RuntimeError(f"{verified} of {total * iters} lanes verified")
        if rank == 0:
            print(json.dumps({"devices": world, "batch": total, "iters": iters,
                              "proofs_per_sec": total * iters / elapsed,
                              "warmup_s": warm_s}), flush=True)
    finally:
        dist.destroy_process_group()


def point(world: int, per_rank: int, iters: int, device: str, timeout: float = 3600) -> dict:
    """One point: ``world`` processes, rank 0's JSON line."""
    env = dict(os.environ, PYTHONPATH=PKG_PARENT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-m", __spec__.name, "--device", device,
                               "--child", str(rank), str(world), str(port), str(per_rank),
                               str(iters)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            p.kill()
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"weak scaling rank {rank} of {world} rc={p.returncode}: "
                               + err[-800:])
    return json.loads(outs[0][0].strip().splitlines()[-1])


def run(per_rank: int = None, iters: int = 4, ranks=None, device: str = "cuda") -> dict:
    """The bench line: a point for each count of ranks, then the
    efficiencies as the JAX bench computes them. On the card the kernels
    are built here, once, before any rank starts."""
    ncores = os.cpu_count() or 1
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (ask for device='cpu' to scale over cores)")
        from .ops import _build

        _build.load_kernels()
        units = torch.cuda.device_count()
    else:
        units = ncores
    per_rank = per_rank or (PER_RANK if device == "cuda" else PER_RANK_CPU)
    ranks = tuple(ranks or (n for n in RANKS if device == "cpu" or n <= units))
    points = [point(n, per_rank, iters, device) for n in ranks]
    base = points[0]["proofs_per_sec"]
    effs, effs_ceiling = {}, {}
    for p in points:
        n = p["devices"]
        effs[str(n)] = round(p["proofs_per_sec"] / (n * base), 4)
        effs_ceiling[str(n)] = round(p["proofs_per_sec"] / (min(n, units) * base), 4)
    what = "cards" if device == "cuda" else "cores"
    line = {
        "metric": "weak_scaling_efficiency_8dev",
        "value": effs_ceiling[str(ranks[-1])],
        "unit": f"fraction (vs min(N,{what}) ceiling)",
        "per_device_batch": per_rank,
        "host_cores": ncores,
        "points": points,
        "efficiency": effs,
        "efficiency_vs_core_ceiling": effs_ceiling,
        "platform": device,
    }
    if device == "cuda":
        line["cards"] = units
    if device == "cuda" and ranks[-1] < RANKS[-1]:
        line["points_note"] = (f"up to {ranks[-1]} ranks: the machine has {units} cards, "
                               f"the metric's 8-device point needs 8")
    if device == "cpu" and per_rank < JAX_PER_RANK:
        line["per_device_batch_note"] = (
            f"{per_rank} lanes a rank, not the JAX bench's {JAX_PER_RANK}: the plain twins "
            "on one core a rank set the time")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--per-rank", type=int, default=None)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--ranks", default=None, help="comma list (default: 1,2,4,8 as available)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--child", nargs=5, type=int, metavar=("RANK", "WORLD", "PORT", "B", "K"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(*args.child, args.device)
        return 0
    ranks = tuple(int(n) for n in args.ranks.split(",")) if args.ranks else None
    print(json.dumps(run(args.per_rank, args.iters, ranks, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Several devices: process groups, device meshes, data-parallel batches and
the sharded MSM, over ``torch.distributed``.

The counterpart of snark_bn254_verifier_tpu/parallel/sharded.py:
``init_distributed`` (:34 there), ``make_mesh`` (:71), ``shard_batch``
(:84), ``replicate`` (:95) and ``sharded_msm`` (:170). JAX runs one
program over a mesh of devices; here each rank is a process that holds
one device and runs these functions on its own part, and collectives go
through the process groups of a ``DeviceMesh`` (NCCL on CUDA, gloo on the
CPU). ``sharded_msm_program`` exists in JAX only so that tests can trace
its shard_map program; it has no counterpart here.

Each rank runs its shard on the card (``device="cuda"``, the default)
unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..models.torch_backend import resolve_device
from ..ops import pairing_cuda as PC


def free_port() -> int:
    """A free TCP port on this host, for ``init_method="tcp://localhost:<port>"``."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     device="cuda") -> None:
    """Join this process to the default process group: NCCL for a CUDA
    device, gloo for the CPU, unless ``backend`` says otherwise. Nothing
    tells a process of its cluster, so a run of several processes passes
    ``init_method`` (e.g. ``tcp://localhost:<port>``), ``world_size`` and
    ``rank``. Idempotent: a process already in a group returns at once.
    On CUDA each rank takes device ``rank % device_count``."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None, model_parallelism: int = 1,
              axis_names: Tuple[str, str] = ("data", "model"), device="cuda") -> DeviceMesh:
    """A (data, model) mesh of every rank of the default group, one device
    a rank: n_devices / model_parallelism by model_parallelism."""
    dev = resolve_device(device)
    n = n_devices or dist.get_world_size()
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} devices needs {n} ranks, "
                         f"the group has {dist.get_world_size()}")
    if n % model_parallelism:
        raise ValueError(f"{n} devices do not split into model axes of {model_parallelism}")
    return init_device_mesh(dev.type, (n // model_parallelism, model_parallelism),
                            mesh_dim_names=tuple(axis_names))


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_batch(tree, mesh: DeviceMesh, axis: str = "data"):
    """This rank's slice of the trailing (batch) axis of every leaf (a
    tensor or array) of ``tree`` (nested tuples, lists and dicts), on the
    rank's device: the axis split in as many equal parts as it has ranks,
    this rank's part. Batched verification then runs on every rank's
    lanes with no collective."""
    sub, dev = mesh[axis], _mesh_device(mesh)
    size, part = sub.size(), sub.get_local_rank()

    def take(leaf):
        leaf = torch.as_tensor(leaf)
        b = leaf.shape[-1]
        if b % size:
            raise ValueError(f"a batch of {b} does not split over {size} ranks")
        return leaf[..., part * (b // size):(part + 1) * (b // size)].contiguous().to(dev)

    return _tree_map(take, tree)


def replicate(tree, mesh: DeviceMesh):
    """Every leaf of ``tree`` whole on this rank's device."""
    dev = _mesh_device(mesh)
    return _tree_map(lambda leaf: torch.as_tensor(leaf).to(dev), tree)


def sharded_msm(mesh: DeviceMesh, points, scalars, axis: str = "model", c: int = 8):
    """The MSM per lane with the point axis sharded over ``axis``.

    points (x (N,16,B), y (N,16,B), inf (N,B)) and scalars (N,16,B) as
    ops/msm.py takes them, all N points on every rank; N must divide by
    the axis's size. Each rank runs K6's stages 1-5 on its N / size points
    (ops/pairing_cuda.py::msm_pippenger_windows: its (B, W, 24) Jacobian
    window sums), the window sums are gathered over the axis's process
    group, and each rank runs K6's combine once on all of them
    (``msm_pippenger_combine``: the sets added window by window, then
    Horner); the plain twins on the CPU. No scalar multiplication by one
    remains, as the JAX package's sum of its shards' partials has none.
    Returns the affine sum (x (16,B), y (16,B), inf (B,)), the same on
    every rank of the axis."""
    sub, dev = mesh[axis], _mesh_device(mesh)
    size, part = sub.size(), sub.get_local_rank()
    n = points[0].shape[0]
    if n % size:
        raise ValueError(f"{n} points do not split over {size} ranks")
    lo, hi = part * (n // size), (part + 1) * (n // size)
    local = tuple(torch.as_tensor(t)[lo:hi].contiguous().to(dev) for t in points)
    mine = PC.msm_pippenger_windows(
        local, torch.as_tensor(scalars)[lo:hi].contiguous().to(dev), c)
    parts = [torch.empty_like(mine) for _ in range(size)]
    dist.all_gather(parts, mine, group=sub.get_group())
    return PC.msm_pippenger_combine(torch.stack(parts), c)

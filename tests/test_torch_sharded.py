"""The port's multi-device layer (parallel/sharded.py) over torch.distributed
on the CPU: two gloo processes run sharded_msm on N = 128 trapdoor points
(each rank the plain twin of K6's window sums on its 64, then the twin of
K6's combine on both ranks' sets), and both ranks get the closed form;
shard_batch gives each rank its slice and replicate the whole; at world
size 1 sharded_msm equals msm_best. The counterpart of
tests/test_multihost.py, with its own worker (tests/torch_dist_worker.py)."""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [2, 1])
def test_sharded_msm_over_gloo_processes(world):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(rank), str(world), str(port)],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("sharded MSM workers timed out\n" + "\n".join(outs))
    for rank, p in enumerate(procs):
        assert p.returncode == 0, f"rank {rank} failed:\n{outs[rank]}"
        assert f"rank {rank}: OK" in outs[rank]


def test_cuda_mesh_without_a_gpu_raises():
    import torch

    from snark_bn254_verifier_tpu_torch.parallel.sharded import init_distributed

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        init_distributed(init_method="tcp://localhost:1", world_size=1, rank=0)

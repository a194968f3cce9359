"""One rank of the port's sharded MSM on the CPU (gloo), launched by
tests/test_torch_sharded.py as ``python torch_dist_worker.py RANK WORLD
PORT``. Exits 0 when, on this rank, sharded_msm over every rank equals the
closed form of the trapdoor data of tests/dist_worker.py (n = 128, seed
23), shard_batch gives this rank its slice of the batch axis and
replicate the whole; at world size 1, when sharded_msm also equals
msm_best on the same points."""

import sys

import numpy as np
import torch
import torch.distributed as dist


def main() -> int:
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from snark_bn254_verifier_tpu_torch.fixtures.msm_lanes import trapdoor_msm
    from snark_bn254_verifier_tpu_torch.models.packing import pack_msm, unpack_g1
    from snark_bn254_verifier_tpu_torch.ops import msm as M
    from snark_bn254_verifier_tpu_torch.parallel.sharded import (
        init_distributed,
        make_mesh,
        replicate,
        sharded_msm,
        shard_batch,
    )

    init_distributed(init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
                     device="cpu")
    init_distributed(init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
                     device="cpu")  # idempotent
    n = 128 if world > 1 else 64
    pts, scs, expected = trapdoor_msm(n, 23)
    points, scalars = pack_msm(pts, scs)
    points = tuple(torch.as_tensor(a) for a in points)
    scalars = torch.as_tensor(scalars)
    model = make_mesh(model_parallelism=world, device="cpu")
    got = sharded_msm(model, points, scalars)
    assert unpack_g1(*got)[0] == expected, f"rank {rank}: sharded MSM != closed form"
    if world == 1:
        want = M.msm_best(points, scalars)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), "world 1 != msm_best"

    data = make_mesh(device="cpu")  # every rank on the data axis
    lanes = 2 * world
    tree = (np.arange(16 * lanes).reshape(16, lanes), {"inf": torch.arange(lanes) % 2 == 0})
    mine = shard_batch(tree, data)
    assert torch.equal(mine[0], torch.as_tensor(tree[0])[:, 2 * rank:2 * rank + 2])
    assert torch.equal(mine[1]["inf"], tree[1]["inf"][2 * rank:2 * rank + 2])
    whole = replicate(tree, data)
    assert torch.equal(whole[0], torch.as_tensor(tree[0])) and whole[1]["inf"].shape == (lanes,)
    # rank 0 holds the group's store: no rank leaves while another still
    # talks to it
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One rank of the 4-process gloo run of ``tests/test_torch_comm.py``.

``python tests/test_torch_comm_worker.py RANK WORLD INIT_FILE OUT`` joins a
gloo process group through ``file://INIT_FILE``, calls each of the port's
remaining comm verbs on this rank's part of ``tests/test_comm.py``'s
inputs (rank ``r`` holds row ``r`` of the sharded arrays), and saves what
each returned to ``OUT``. It imports torch and the port only.
"""

import datetime
import os
import sys

import torch
import torch.distributed as tdist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deepspeed_tpu_torch.comm import comm as dist  # noqa: E402


def main():
    rank, world, init_file, out_path = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                             world_size=world, timeout=datetime.timedelta(seconds=60))
    x = torch.arange(float(world))[rank:rank + 1]        # tests/test_comm.py's arange
    a = torch.arange(8.0).reshape(4, 2)[rank:rank + 1]   # per rank [1, 2]
    b = torch.arange(4.0)[rank:rank + 1]                 # per rank [1]
    out = {
        "send_next": dist.send_next(x),
        "send_prev": dist.send_prev(x),
        "send_recv": dist.send_recv(x, [(0, 2), (2, 0)]),
        "reduce": dist.reduce(x.clone(), dst=1),
        "gather": dist.gather(a, dst=0),
        "scatter": dist.scatter(torch.arange(8.0) * (rank == 2), src=2),
        "all_reduce_coalesced": dist.all_reduce_coalesced([a, b]),
        "all_gather_coalesced": dist.all_gather_coalesced([a, b]),
        "isend": dist.isend(a, dst=1, src=0).wait(),
        "irecv": dist.irecv(a, src=3, dst=2).wait(),
        "mixed_reduce": dist.all_reduce_coalesced(
            [torch.ones(1, 2, dtype=torch.bfloat16), torch.ones(1, 3)]),
        "mixed_gather": dist.all_gather_coalesced(
            [torch.ones(1, 2, dtype=torch.bfloat16), torch.ones(1, 3)]),
        "rank": dist.get_rank(), "world": dist.get_world_size(),
    }
    dist.monitored_barrier()
    dist.barrier()
    torch.save(out, out_path)
    tdist.destroy_process_group()


if __name__ == "__main__":
    main()

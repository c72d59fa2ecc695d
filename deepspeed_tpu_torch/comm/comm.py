"""Process groups and collectives (port of ``deepspeed_tpu/comm/comm.py``).

The JAX package names a mesh axis where the reference names a process group;
here the collectives run over ``torch.distributed`` and take ``group`` (a
process group, or None for the whole world), as the reference's
``deepspeed/comm/comm.py`` does. The backend is NCCL for CUDA tensors and
gloo for the CPU (the tests). Every collective works without a process group
when the world is one process: it returns its input, as a one-device axis
does in the JAX package. Collectives that torch runs in place return the
tensor they wrote.

``all_to_all`` and ``with_transpose`` are differentiable: the backward of
an exchange is the exchange that transposes it (the MoE dispatch and
combine run through them under autograd, as the JAX collectives do under
``jax.grad``).

``init_distributed`` discovers the rank and world size from the launcher's
environment (``discover_process_env``) and calls
``torch.distributed.init_process_group``; on CUDA it first binds the process
to ``cuda:LOCAL_RANK``. The comms logger waits for ROADMAP A15.
"""

import datetime
import os

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["ReduceOp", "discover_process_env", "init_distributed", "is_initialized",
           "get_rank", "get_world_size", "get_local_rank", "barrier", "all_reduce",
           "all_gather", "reduce_scatter", "all_to_all_single", "all_to_all",
           "with_transpose", "broadcast", "destroy_process_group"]

DEFAULT_TIMEOUT_S = 1800


class ReduceOp:
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"
    PRODUCT = "prod"


# gloo has no AVG: it is a SUM divided by the group's size
_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
              ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}


def discover_process_env(environ=None):
    """(coordinator, num_processes, process_id) from the launcher's
    MASTER_ADDR/WORLD_SIZE/RANK (torchrun), or their DST_* names. Each
    process's card is ``get_local_rank()``, from LOCAL_RANK or
    DST_LOCAL_RANK."""
    env = os.environ if environ is None else environ
    coordinator = env.get("DST_COORDINATOR_ADDRESS") or env.get("MASTER_ADDR")
    num_proc = int(env.get("DST_NUM_PROCESSES", env.get("WORLD_SIZE", "1")))
    proc_id = int(env.get("DST_PROCESS_ID", env.get("RANK", "0")))
    return coordinator, num_proc, proc_id


def init_distributed(dist_backend=None, distributed_port=29500, verbose=True,
                     timeout=None, init_method=None, rank=-1, world_size=-1):
    """Join the process group (reference ``comm/comm.py:604``).

    Rank and world size come from ``discover_process_env`` unless given;
    ``init_method`` defaults to ``tcp://MASTER_ADDR:MASTER_PORT``. The backend
    is ``dist_backend``, else NCCL when CUDA is available and gloo otherwise.
    A world of one process joins nothing. ``timeout`` (seconds) bounds every
    collective, so a rank that died fails the others instead of hanging
    them."""
    if is_initialized():
        return
    coordinator, num_proc, proc_id = discover_process_env()
    if rank >= 0:
        proc_id = rank
    if world_size > 0:
        num_proc = world_size
    if num_proc <= 1:
        return
    backend = dist_backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(get_local_rank())
    if init_method is None:
        port = int(os.environ.get("MASTER_PORT", distributed_port))
        init_method = f"tcp://{coordinator or 'localhost'}:{port}"
    if verbose:
        logger.info(f"init_distributed: {backend} {init_method} process "
                    f"{proc_id}/{num_proc}")
    dist.init_process_group(
        backend=backend, init_method=init_method, rank=proc_id,
        world_size=num_proc,
        timeout=datetime.timedelta(seconds=timeout or DEFAULT_TIMEOUT_S))


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def destroy_process_group():
    if is_initialized():
        dist.destroy_process_group()


def get_rank(group=None):
    return dist.get_rank(group) if is_initialized() else 0


def get_world_size(group=None):
    return dist.get_world_size(group) if is_initialized() else 1


def get_local_rank():
    return int(os.environ.get("DST_LOCAL_RANK", os.environ.get("LOCAL_RANK", "0")))


def barrier(group=None):
    if get_world_size(group) > 1:
        dist.barrier(group=group)


def _alone(group):
    return get_world_size(group) == 1


def all_reduce(tensor, op=ReduceOp.SUM, group=None):
    """In-place all-reduce of ``tensor`` over ``group``; returns it
    (reference ``comm/comm.py:483``)."""
    if _alone(group):
        return tensor
    dist.all_reduce(tensor, op=_TORCH_OPS[op], group=group)
    if op == ReduceOp.AVG:
        tensor.div_(get_world_size(group))
    return tensor


def all_gather(tensor, group=None, axis=0, tiled=True, out=None):
    """Gather ``tensor`` from every rank of ``group``: concatenated along
    ``axis`` (``tiled``) or stacked on a new leading axis. ``out``, a
    contiguous tensor of the result's size, receives a gather along axis 0
    in place."""
    n = get_world_size(group)
    if n == 1:
        result = tensor if tiled else tensor[None]
        return result if out is None else out.copy_(result.reshape(out.shape))
    src = tensor.movedim(axis, 0).contiguous() if tiled and axis else tensor.contiguous()
    if out is not None:
        if axis:
            raise ValueError("all_gather into out= gathers along axis 0")
        dist.all_gather_into_tensor(out, src, group=group)
        return out
    # gloo takes the concatenated form only
    result = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                         device=src.device)
    dist.all_gather_into_tensor(result, src, group=group)
    if not tiled:
        return result.view((n,) + tuple(src.shape))
    return result.movedim(0, axis) if axis else result


def reduce_scatter(tensor, op=ReduceOp.SUM, group=None, scatter_dim=0):
    """Sum ``tensor`` over ``group`` and keep this rank's slice of
    ``scatter_dim``, whose size the group's size must divide."""
    n = get_world_size(group)
    if n == 1:
        return tensor
    src = tensor.movedim(scatter_dim, 0) if scatter_dim else tensor
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {scatter_dim} of size {src.shape[0]} "
                         f"is not divisible by the group's {n} ranks")
    src = src.contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.reduce_scatter_tensor(out, src, op=_TORCH_OPS[op], group=group)
    if op == ReduceOp.AVG:
        out.div_(n)
    return out.movedim(0, scatter_dim) if scatter_dim else out


def all_to_all_single(tensor, group=None):
    """Block j of dim 0 of ``tensor`` goes to rank j of ``group``; block j of
    the result is what rank j sent here (``lax.all_to_all`` with
    ``split_axis=concat_axis=0``)."""
    if _alone(group):
        return tensor
    src = tensor.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


class _Transposed(torch.autograd.Function):
    """``fwd(x, group)`` forward, ``bwd(grad, group)`` backward."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, group):
        ctx.bwd, ctx.group = bwd, group
        return fwd(x, group)

    @staticmethod
    def backward(ctx, grad):
        return ctx.bwd(grad.contiguous(), ctx.group), None, None, None


def with_transpose(x, fwd, bwd, group=None):
    """``fwd(x, group)``, a collective, through autograd with ``bwd`` (the
    collective that transposes it) as its backward. A group of one rank
    returns ``x``."""
    if _alone(group):
        return x
    return _Transposed.apply(x, fwd, bwd, group)


def all_to_all(tensor, group=None):
    """``all_to_all_single`` through autograd: at equal splits the exchange
    is its own transpose, so its backward is the same exchange of the
    gradient (reference ``comm/comm.py:350``, ``sharded_moe._AllToAll``)."""
    return with_transpose(tensor, all_to_all_single, all_to_all_single, group)


def broadcast(tensor, src=0, group=None):
    """In place: every rank of ``group`` takes global rank ``src``'s value."""
    if _alone(group):
        return tensor
    dist.broadcast(tensor, src=src, group=group)
    return tensor

"""Error-feedback sign-compressed allreduce (port of
``deepspeed_tpu/runtime/comm/compressed.py``).

A two-phase average over a ``torch.distributed`` group that moves one sign
bit per element plus one fp32 scale per rank and phase, with worker- and
server-side error feedback so that the compression noise averages out over
steps (the reference's ``NcclBackend.compressed_allreduce``):

1. each rank compresses its padded tensor plus its worker error to signs
   and one scale (``sign_compress``), packs the signs eight to a byte
   (``packbits``, big-endian within a byte as ``jnp.packbits``) and sends
   chunk ``j`` to rank ``j`` (all-to-all); the scales are all-gathered;
2. rank ``j`` averages the ``world`` decompressed copies of its chunk,
   compresses that with its server error, and the packed server chunks and
   their scales are all-gathered: every rank decompresses the same result.

The tensor is padded so that each rank's chunk is a whole number of bytes
(``error_shapes``). ``sign_compress`` is also the core of the 1-bit
optimizers (``ops/onebit.py``); the engine does not call the wire verb, as
the JAX engine does not. On the CPU the group is gloo over CPU tensors.
"""

import torch

from deepspeed_tpu_torch.comm import comm as dist


def _bits(device):
    """The weights of a byte's bits, the first the most significant."""
    return (2 ** torch.arange(7, -1, -1, device=device)).to(torch.uint8)


def sign_compress(x, error, mask=None, norm=None, numel=None):
    """``(decompressed, new_error, scale, bits)`` of ``x + error``:
    ``decompressed = scale * sign`` with zeros compressing to +1 and
    ``scale = |x + error| / sqrt(numel)`` (the l2 norm kept), zeroed where
    ``mask`` is False; ``new_error`` is what was left unapplied. ``norm``
    and ``numel`` (a piece of a larger leaf, the 1-bit optimizers') give
    the whole leaf's norm and size."""
    corrected = x + error
    if norm is None:
        norm = torch.linalg.vector_norm(corrected.float())
    n = corrected.numel() if numel is None else numel
    # the count made on the device (a host scalar tensor would be a
    # synchronising copy), its root taken in fp32 as JAX takes it
    scale = norm / torch.sqrt(torch.full((), float(n), dtype=torch.float32, device=norm.device))
    bits = corrected >= 0
    decompressed = scale * torch.where(bits, 1.0, -1.0).to(x.dtype)
    if mask is not None:
        decompressed = torch.where(mask, decompressed, torch.zeros_like(decompressed))
    return decompressed, corrected - decompressed, scale, bits


def packbits(bits):
    """``jnp.packbits`` of a flat bool tensor whose length is a multiple of
    8: uint8, the first element in the most significant bit."""
    b = bits.reshape(-1, 8).to(torch.uint8)
    return (b * _bits(b.device)).sum(dim=1, dtype=torch.uint8)


def unpackbits(packed):
    """``jnp.unpackbits`` of a uint8 tensor along its last axis -> bool."""
    bits = (packed.unsqueeze(-1) & _bits(packed.device)) != 0
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)


def error_shapes(n, world):
    """Shapes of the (worker_error, server_error) buffers for an
    ``n``-element tensor: each rank's chunk rounded up to whole bytes."""
    chunk = (-(-n // world) + 7) // 8 * 8
    return (chunk * world,), (chunk,)


def init_error_buffers(n, world, device=None, dtype=torch.float32):
    w, s = error_shapes(n, world)
    return torch.zeros(w, dtype=dtype, device=device), torch.zeros(s, dtype=dtype,
                                                                   device=device)


def _compress(flat, error):
    decompressed, new_error, scale, bits = sign_compress(flat, error)
    return packbits(bits), scale, new_error


def compressed_allreduce(tensor, worker_error, server_error, group=None):
    """Average ``tensor`` over ``group`` with 1-bit compression. Returns
    ``(averaged, new_worker_error, new_server_error)``; the error buffers
    (``error_shapes``) are state the caller threads between steps."""
    world = dist.get_world_size(group)
    flat = tensor.reshape(-1).float()
    n = flat.numel()
    w_shape, s_shape = error_shapes(n, world)
    chunk = s_shape[0]
    if worker_error.numel() != w_shape[0] or server_error.numel() != chunk:
        raise ValueError(f"error buffers must be sized by error_shapes(): need "
                         f"{w_shape}/{s_shape}, got ({worker_error.numel()},)/"
                         f"({server_error.numel()},)")
    flat = torch.nn.functional.pad(flat, (0, w_shape[0] - n))

    # phase 1: worker compression, packed chunks all-to-all, scales gathered
    packed, scale, new_worker_error = _compress(flat, worker_error.reshape(-1))
    recv = dist.all_to_all_single(packed.reshape(world, chunk // 8), group=group)
    scales = dist.all_gather(scale.reshape(1), group=group)
    signs = torch.where(unpackbits(recv.reshape(world, chunk // 8)), 1.0, -1.0)
    server_chunk = (signs * scales[:, None]).mean(dim=0)

    # phase 2: server compression, packed server chunks and scales gathered
    packed_s, scale_s, new_server_error = _compress(server_chunk, server_error.reshape(-1))
    gathered = dist.all_gather(packed_s, group=group).reshape(world, chunk // 8)
    scales_s = dist.all_gather(scale_s.reshape(1), group=group)
    out = (torch.where(unpackbits(gathered), 1.0, -1.0) * scales_s[:, None]).reshape(-1)[:n]
    return (out.reshape(tensor.shape).to(tensor.dtype), new_worker_error,
            new_server_error)


def compressed_allreduce_reference(tensors, worker_errors, server_errors):
    """``compressed_allreduce`` of the ranks' ``tensors`` computed in one
    process, without communication: the plain version the collective is
    held to. Returns ``(averaged, new_worker_errors, new_server_errors)``,
    the errors one per rank."""
    world = len(tensors)
    n = tensors[0].numel()
    w_shape, s_shape = error_shapes(n, world)
    chunk = s_shape[0]
    flats = [torch.nn.functional.pad(t.reshape(-1).float(), (0, w_shape[0] - n))
             for t in tensors]
    worker = [sign_compress(f, e.reshape(-1)) for f, e in zip(flats, worker_errors)]
    new_worker = [w[1] for w in worker]
    servers = []
    for j in range(world):
        parts = [w[2] * torch.where(w[3][j * chunk:(j + 1) * chunk], 1.0, -1.0)
                 for w in worker]
        servers.append(sign_compress(torch.stack(parts).mean(dim=0),
                                     server_errors[j].reshape(-1)))
    out = torch.cat([s[2] * torch.where(s[3], 1.0, -1.0) for s in servers])[:n]
    return (out.reshape(tensors[0].shape).to(tensors[0].dtype), new_worker,
            [s[1] for s in servers])

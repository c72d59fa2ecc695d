"""Groupwise quantize / dequantize-reduce: the ZeRO++ wire ops.

Port of ``deepspeed_tpu/ops/pallas/quant_collective.py``: ``block_quantize``
(``_quantize_rows_local``, ``pl.pallas_call`` at :273) produces the int8 /
int4 wire payload of the qgZ exchange and ``block_dequantize_reduce``
(``_deq_reduce_local``, ``pl.pallas_call`` at :344) consumes it, fused with
the sum over peers; ``block_dequantize`` is the same kernel with one peer.
On CUDA tensors each launches a hand-written Hopper kernel of
``csrc/quant_collective.cu`` and counts the launch in
``block_quantize.launches`` or ``block_dequantize_reduce.launches`` (which
``block_dequantize`` shares: it is that kernel); on CPU tensors each runs
its plain PyTorch version. The kernels take every shape, so a CUDA tensor
never reaches a plain version through these wrappers.

The source routes each call by its shape (``kernel_route``;
``kernel_launches`` reads the library's tally of what each call launched).
The main path's shapes take ``quantize_warp`` (one warp per group, held in
registers: groups of 1 to 8 KB in whole KB) and ``dequant_reduce_stream``
(persistent blocks fed by bulk copies through a ring of shared-memory
stages: group sizes a multiple of 256 whose P wire rows fit one 16 KB
stage, at most 8 peers), both on rows whose byte length is a multiple of
16 and on 16-byte aligned data; every other call goes to the ``block``
kernels, one thread block per group.

Wire formats, bit for bit the JAX package's (its module docstring):

- 8-bit: int8, one byte per element;
- 4-bit: uint8, two elements per byte, half-split packed per group: byte
  ``j`` of a group holds element ``j`` (low nibble) and element
  ``j + group_size // 2`` (high nibble);
- one fp32 scale per group: ``amax / qmax`` (1 where the group is all
  zeros), ``q = clip(round_half_even(x / scale), -qmax, qmax)``.
"""

import ctypes

import torch

DEFAULT_GROUP = 2048
# the source's enum Kernel, in order
KERNELS = ("quantize_warp", "quantize_block", "dequant_reduce_stream",
           "dequant_reduce_block")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}
_OPS = {"quantize": 0, "dequantize_reduce": 1}


def _qmax(num_bits, device):
    # a 0-d tensor on the data's device: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which is not the IEEE quotient
    return torch.tensor(127.0 if num_bits == 8 else 7.0, dtype=torch.float32,
                        device=device)


def _check_bits(num_bits, group_size):
    if num_bits not in (8, 4):
        raise ValueError(f"num_bits must be 8 or 4, got {num_bits}")
    if num_bits == 4 and group_size % 2:
        raise ValueError(f"4-bit packing needs an even group_size, got {group_size}")


def _wire_width(num_bits, group_size):
    return group_size if num_bits == 8 else group_size // 2


# ---------------------------------------------------------------------------
# plain versions (the JAX package's jnp twins)
# ---------------------------------------------------------------------------

def _quantize_rows_ref(rows, num_bits):
    """rows [N, group_size] (one group per row) -> (q_rows [N, gsw], scale [N])."""
    rows = rows.float()
    qmax = _qmax(num_bits, rows.device)
    amax = rows.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.minimum(torch.maximum(torch.round(rows / scale), -qmax), qmax).to(torch.int32)
    if num_bits == 4:
        h = rows.shape[1] // 2
        q = ((q[:, :h] & 0xF) | ((q[:, h:] & 0xF) << 4)).to(torch.uint8)
    else:
        q = q.to(torch.int8)
    return q, scale[:, 0]


def _unpack(q, num_bits):
    """Wire rows [N, gsw] -> int32 values [N, group_size]."""
    qi = q.to(torch.int32)
    if num_bits == 8:
        return qi
    lo = qi & 0xF
    hi = (qi >> 4) & 0xF
    lo = torch.where(lo > 7, lo - 16, lo)    # sign-extend 4-bit two's complement
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.cat([lo, hi], dim=-1)


def _dequantize_rows_ref(q_rows, scale, num_bits):
    """q_rows [N, gsw] + scale [N] -> [N, group_size] fp32."""
    return _unpack(q_rows, num_bits).float() * scale.float()[:, None]


def _dequantize_reduce_ref(q3, s2, num_bits):
    """q3 [P, N, gsw] + s2 [P, N] -> [N, group_size] fp32: a loop over the
    peers in order from zeros, one rounding per product and per sum, as the
    kernel adds them."""
    acc = None
    for p in range(q3.shape[0]):
        term = _dequantize_rows_ref(q3[p], s2[p], num_bits)
        acc = torch.zeros_like(term) + term if acc is None else acc + term
    return acc


def _prep_rows(x, group_size):
    """[R, M] -> padded group-rows [R*G, group_size] fp32 (+ R, G)."""
    R, M = x.shape
    G = max(1, -(-M // group_size))
    xf = x.float()
    if G * group_size != M:
        xf = torch.nn.functional.pad(xf, (0, G * group_size - M))
    return xf.reshape(R * G, group_size), R, G


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _library():
    from deepspeed_tpu_torch.ops import cuda_build
    lib = cuda_build.load("quant_collective")
    if lib.ds_block_quantize.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ds_block_quantize.argtypes = [p, p, p, ll, ll, i, i, i, i, p]
        lib.ds_block_quantize.restype = i
        lib.ds_block_dequantize_reduce.argtypes = [p, p, p, i, ll, i, i, ll, i, p]
        lib.ds_block_dequantize_reduce.restype = i
        lib.ds_quant_route.argtypes = [i, ll, i, i, i, i, i]
        lib.ds_quant_route.restype = i
        lib.ds_quant_kernel_launches.argtypes = [i]
        lib.ds_quant_kernel_launches.restype = ll
        lib.ds_quant_error_string.argtypes = [i]
        lib.ds_quant_error_string.restype = ctypes.c_char_p
    return lib


def kernel_route(op, length, group_size=DEFAULT_GROUP, num_bits=8, dtype=torch.float32,
                 peers=1, aligned=True):
    """The kernel (a name of ``KERNELS``) that a call launches, as the
    kernel source decides it (``ds_quant_route``): ``op`` "quantize" of
    rows of ``length`` elements of ``dtype``, or "dequantize_reduce" of
    ``peers`` wire rows into rows of ``length`` fp32 outputs; ``aligned``
    says whether the call's data pointers are 16-byte aligned (a fresh
    tensor's are; an offset view's may not be). Builds the library."""
    k = _library().ds_quant_route(_OPS[op], int(length), group_size, num_bits,
                                  _DTYPE_CODES.get(dtype, -1), peers, int(aligned))
    if k < 0:
        raise ValueError(f"no quant collective kernel takes {op} of length {length}, "
                         f"group {group_size}, {num_bits} bits, {dtype}, {peers} peers")
    return KERNELS[k]


def kernel_launches():
    """{kernel: launches so far} over ``KERNELS``, counted by the library
    where it launches each kernel: which kernels the calls went to."""
    lib = _library()
    return {name: lib.ds_quant_kernel_launches(i) for i, name in enumerate(KERNELS)}


def _raise_on(rc, name):
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_library().ds_quant_error_string(rc).decode()}")


def _on_cuda_or_raise(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {t.device}")


def _quantize_cuda(x, num_bits, group_size):
    """x [R, M] fp32/bf16 on the card -> (q [R, G*gsw], scale [R, G])."""
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        x, code = x.float(), 0
    if not x.is_contiguous():
        x = x.contiguous()
    R, M = x.shape
    G = max(1, -(-M // group_size))
    q = torch.empty(R, G * _wire_width(num_bits, group_size), dtype=
                    torch.int8 if num_bits == 8 else torch.uint8, device=x.device)
    scale = torch.empty(R, G, dtype=torch.float32, device=x.device)
    rc = _library().ds_block_quantize(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), R, M, G, group_size, num_bits,
        code, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "block_quantize")
    block_quantize.launches += 1
    return q, scale


def _dequantize_reduce_cuda(q, scale, P, R, G, num_bits, group_size, out_cols):
    """q [P, R*G*gsw] + scale [P, R*G] on the card -> fp32 [R, out_cols]."""
    if not q.is_contiguous():
        q = q.contiguous()
    if scale.dtype != torch.float32:
        scale = scale.float()
    if not scale.is_contiguous():
        scale = scale.contiguous()
    out = torch.empty(R, out_cols, dtype=torch.float32, device=q.device)
    rc = _library().ds_block_dequantize_reduce(
        q.data_ptr(), scale.data_ptr(), out.data_ptr(), P, R, G, group_size, out_cols,
        num_bits, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "block_dequantize_reduce")
    block_dequantize_reduce.launches += 1
    return out


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def block_quantize(x, num_bits=8, group_size=DEFAULT_GROUP):
    """Groupwise symmetric quantization of payload rows: the wire producer.

    ``x`` [R, M] (or 1D [M], one row), fp32 or bf16 (other floats are
    widened to fp32): each row is split into ``G = ceil(M / group_size)``
    groups (zero-padded). Returns ``(q, scale)``: ``q`` [R, G*group_size]
    int8 (8-bit) or [R, G*group_size//2] half-split-packed uint8 (4-bit),
    ``scale`` [R, G] fp32. 1D input gives 1D outputs."""
    _check_bits(num_bits, group_size)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    if x.device.type == "cpu":
        rows, R, G = _prep_rows(x, group_size)
        q_rows, scale = _quantize_rows_ref(rows, num_bits)
        q, scale = q_rows.reshape(R, -1), scale.reshape(R, G)
    else:
        _on_cuda_or_raise("block_quantize", x)
        q, scale = _quantize_cuda(x, num_bits, group_size)
    return (q[0], scale[0]) if squeeze else (q, scale)


block_quantize.launches = 0


def block_dequantize_reduce(q, scale, num_bits=8, group_size=DEFAULT_GROUP,
                            out_len=None, dtype=torch.float32):
    """Fused dequantize + sum over peers: the exchange-reduce consumer.

    ``q`` [P, wire] and ``scale`` [P, G] as :func:`block_quantize` makes
    them (one row per peer); returns the [out_len] sum over the P peers,
    taken in peer order in fp32 (``out_len`` defaults to G*group_size)."""
    _check_bits(num_bits, group_size)
    P, G = scale.shape
    out_len = G * group_size if out_len is None else int(out_len)
    if q.device.type == "cpu":
        gsw = q.shape[1] // G
        out = _dequantize_reduce_ref(q.reshape(P, G, gsw), scale, num_bits)
        out = out.reshape(G * group_size)[:out_len]
    else:
        _on_cuda_or_raise("block_dequantize_reduce", q)
        out = _dequantize_reduce_cuda(q, scale, P, 1, G, num_bits, group_size, out_len)[0]
    return out if out.dtype == dtype else out.to(dtype)


block_dequantize_reduce.launches = 0


def block_dequantize(q, scale, num_bits=8, group_size=DEFAULT_GROUP,
                     out_len=None, dtype=torch.float32):
    """Row-wise dequantization (no reduction): the all-gather consumer.

    ``q`` [R, wire] + ``scale`` [R, G] -> [R, out_len]. Runs the reduce
    kernel with one peer (its launches count in
    ``block_dequantize_reduce.launches``), each row straight into its
    output slot."""
    _check_bits(num_bits, group_size)
    R, G = scale.shape
    out_len = G * group_size if out_len is None else int(out_len)
    if q.device.type == "cpu":
        gsw = q.shape[1] // G
        out = _dequantize_reduce_ref(q.reshape(1, R * G, gsw), scale.reshape(1, R * G),
                                     num_bits)
        out = out.reshape(R, G * group_size)[:, :out_len]
    else:
        _on_cuda_or_raise("block_dequantize", q)
        out = _dequantize_reduce_cuda(q, scale, 1, R, G, num_bits, group_size, out_len)
    return out if out.dtype == dtype else out.to(dtype)


def wire_nbytes(numel, num_bits, group_size=DEFAULT_GROUP):
    """True wire footprint of ``numel`` payload elements: packed ints plus
    fp32 group scales (logical bytes stay the fp32 ``numel * 4``)."""
    groups = max(1, -(-numel // group_size))
    return groups * _wire_width(num_bits, group_size) + groups * 4

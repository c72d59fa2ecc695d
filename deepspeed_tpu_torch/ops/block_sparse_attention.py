"""Block-sparse attention (port of
``deepspeed_tpu/ops/pallas/block_sparse_attention.py``).

The [H, nq, nk] 0/1 block layout of a ``SparsityConfig`` is compacted on the
host into per-(head, query block) lists of enabled key blocks plus counts
(``compact_layout``, the JAX function). ``sparse_mha_fwd`` computes attention
over exactly those blocks: on CUDA tensors it launches a hand-written Hopper
kernel of ``csrc/block_sparse_attention.cu`` (counted in
``sparse_mha_fwd.launches``), on CPU tensors it runs the plain version
``sparse_mha_fwd_reference``, which repeats the TPU kernel's function in its
order and at its rounding points. A CUDA tensor never reaches the plain
version through the wrapper: what the kernels cannot take raises.

The kernel source chooses each call's kernel (``kernel_route`` reads the
choice, ``kernel_launches`` counts what each call launched): bf16/fp16 at
block 64 or 128 and head width up to 128 run the ``wgmma`` kernel fed by
TMA, a persistent grid over work items taken in descending ``counts`` order
(``work_order``, computed once per layout beside ``compact_layout``);
everything else runs the SIMT kernel.

``sparse_mha`` is the differentiable entry point, a ``torch.autograd.Function``
whose forward is ``sparse_mha_fwd``. Its backward, like the JAX custom VJP,
is no kernel: it recomputes ``blockwise_sparse_attention``'s function in
plain torch, one query block at a time over that block's enabled keys, and
backpropagates each block before the next, so memory stays O(S x block).

Layouts are the JAX package's: q/k/v [B, H, S, D]; the output is
[B, H, S, D] contiguous. The TPU dispatch plumbing (``sharded_kernel_call``,
``resolve_block_config``) has no counterpart: each rank holds its own batch.
"""

import ctypes

import numpy as np
import torch

NEG_INF = -1e9
# key blocks the kernels stage whole (csrc/block_sparse_attention.cu)
MAX_KERNEL_BLOCK = 128

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def compact_layout(layout, causal, block):
    """[H, nq, nk] 0/1 layout -> (cols [H, nq, C], counts [H, nq]) int32
    numpy arrays, the JAX function.

    Causal folds in by dropping blocks entirely above the diagonal; C is the
    max enabled count over all (h, iq); padding repeats the last enabled
    index (or 0 when a row has none — counts gates the compute)."""
    layout = np.asarray(layout, bool).copy()
    H, nq, nk = layout.shape
    if causal:
        # equal q/k block sizes: a block is fully above the diagonal iff ik > iq
        layout &= np.tril(np.ones((nq, nk), bool))[None]
    counts = layout.sum(axis=-1).astype(np.int32)
    C = max(int(counts.max()), 1)
    # stable argsort of ~layout lists enabled column indices first, ascending
    order = np.argsort(~layout, axis=-1, kind="stable")[:, :, :C].astype(np.int32)
    slot = np.arange(C)[None, None, :]
    last = np.take_along_axis(
        order, np.maximum(counts - 1, 0)[:, :, None], axis=-1)
    cols = np.where(slot < counts[:, :, None], order, last)
    cols = np.where(counts[:, :, None] == 0, 0, cols).astype(np.int32)
    return cols, counts


def is_supported(q_shape, block):
    """The JAX package's test: S % block == 0, block % 8 == 0, D <= 256."""
    B, H, S, D = q_shape
    return S % block == 0 and block % 8 == 0 and D <= 256


def unsupported_reason(q_shape, block, on_cuda):
    """None if these shapes can run, else a human reason. The kernel also
    needs block <= ``MAX_KERNEL_BLOCK``: it stages a key block whole."""
    if len(q_shape) != 4:
        return f"expected 4D [B, H, S, D] tensors, got {tuple(q_shape)}"
    if block < 1 or not is_supported(q_shape, block):
        return (f"shape {tuple(q_shape)} with block {block} needs S % block "
                f"== 0, block % 8 == 0 and D <= 256")
    if on_cuda and block > MAX_KERNEL_BLOCK:
        return (f"block {block} > {MAX_KERNEL_BLOCK}: the kernel stages a "
                f"whole key block in shared memory")
    return None


def work_order(counts):
    """The tensor-core kernel's order of (head, query block) pairs: h * nq +
    iq as an int32 numpy array [H * nq], most enabled blocks first (ties in
    (h, iq) order), so that the rows that visit the most key blocks (a
    BigBird global row visits all of them) start first and the short ones
    fill the tail."""
    counts = np.asarray(counts)
    return np.argsort(-counts.reshape(-1), kind="stable").astype(np.int32)


def work_items(order, B, nq, block):
    """(b, h, iq, first row) of the tensor-core kernel's work items in launch
    order, as the source's ``sparse_item`` decodes them: each (h, iq) of
    ``order`` gives B x block / 64 consecutive items of 64 query rows."""
    halves = block // 64
    return [(b, int(hq) // nq, int(hq) % nq, (int(hq) % nq) * block + 64 * half)
            for hq in order for b in range(B) for half in range(halves)]


def _schedule(layout, causal, block, device):
    """compact_layout's lists and work_order's as int32 tensors on
    ``device``: (cols, counts, order)."""
    cols, counts = compact_layout(layout, causal, block)
    return tuple(torch.from_numpy(a).to(device) for a in (cols, counts, work_order(counts)))


# ---------------------------------------------------------------------------
# plain version of the kernel
# ---------------------------------------------------------------------------

def sparse_mha_fwd_reference(q, k, v, cols, counts, block, causal, scale):
    """Plain version of the kernel: the TPU kernel's function over the
    compacted lists, slot j of every (head, query block) at once, in slot
    order: s = (q . k in fp32) * scale, the causal mask from global
    positions with NEG_INF inside enabled blocks, the online max and sum in
    fp32, p rounded to v's dtype before an fp32 PV product, acc = acc *
    alpha + pv; rows whose block has counts 0 come out exactly 0."""
    B, H, S, D = q.shape
    nq = S // block
    C = cols.shape[-1]
    cols = cols.to(device=q.device, dtype=torch.long)
    counts = counts.to(device=q.device, dtype=torch.long)
    qb = q.reshape(B, H, nq, block, D).float()
    kb = k.reshape(B, H, nq, block, D)
    vb = v.reshape(B, H, nq, block, D)
    heads = torch.arange(H, device=q.device)[:, None]
    offs = torch.arange(block, device=q.device)
    qpos = (torch.arange(nq, device=q.device)[:, None] * block + offs)[None, :, :, None]
    m = torch.full((B, H, nq, block, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, H, nq, block, D, dtype=torch.float32, device=q.device)
    for j in range(C):
        idx = cols[:, :, j]                                  # [H, nq]
        kj = kb[:, heads, idx].float()                       # [B, H, nq, block, D]
        s = torch.einsum("bhnqd,bhnkd->bhnqk", qb, kj) * scale
        if causal:
            kpos = (idx[..., None] * block + offs)[:, :, None, :]
            s = torch.where(qpos >= kpos, s, NEG_INF)
        m_cur = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur)
        l_cur = alpha * l + p.sum(-1, keepdim=True)
        pv = torch.einsum("bhnqk,bhnkd->bhnqd", p.to(v.dtype).float(),
                          vb[:, heads, idx].float())
        live = (j < counts)[None, :, :, None, None]
        m = torch.where(live, m_cur, m)
        l = torch.where(live, l_cur, l)
        acc = torch.where(live, acc * alpha + pv, acc)
    out = torch.where(l > 0, acc / torch.where(l == 0, 1.0, l), 0.0)
    return out.to(q.dtype).reshape(B, H, S, D)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

class _SparseParams(ctypes.Structure):
    """Mirror of ``DsSparseParams`` in csrc/block_sparse_attention.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "q", "k", "v", "cols", "counts", "order", "out")]
        + [(n, ctypes.c_longlong) for n in (
            "q_sb", "q_sh", "q_ss", "k_sb", "k_sh", "k_ss", "v_sb", "v_sh",
            "v_ss")]
        + [(n, ctypes.c_int) for n in (
            "B", "H", "S", "dh", "block", "nq", "C", "causal")]
        + [("scale", ctypes.c_float)])


def _library():
    from deepspeed_tpu_torch.ops import cuda_build
    lib = cuda_build.load("block_sparse_attention")
    if lib.ds_block_sparse_fwd.argtypes is None:
        lib.ds_block_sparse_fwd.argtypes = [ctypes.POINTER(_SparseParams),
                                            ctypes.c_int, ctypes.c_void_p]
        lib.ds_block_sparse_fwd.restype = ctypes.c_int
        lib.ds_block_sparse_error_string.argtypes = [ctypes.c_int]
        lib.ds_block_sparse_error_string.restype = ctypes.c_char_p
        lib.ds_sparse_route.argtypes = [ctypes.c_int] * 3
        lib.ds_sparse_route.restype = ctypes.c_int
        lib.ds_sparse_kernel_launches.argtypes = [ctypes.c_int]
        lib.ds_sparse_kernel_launches.restype = ctypes.c_longlong
    return lib


# The kernels in the order of the source's launch tally (enum Kernel).
KERNELS = ("fwd_simt", "fwd_wgmma")


def kernel_route(dtype, block, dh):
    """The kernel (a name of ``KERNELS``) that inputs of ``dtype``, ``block``
    and head width ``dh`` launch, as the kernel source decides it
    (``ds_sparse_route``). Builds the library."""
    k = _library().ds_sparse_route(_DTYPE_CODES[dtype], int(block), int(dh))
    if k < 0:
        raise ValueError(f"no block-sparse kernel takes {dtype} at block {block}, "
                         f"head width {dh}")
    return KERNELS[k]


def kernel_launches():
    """{kernel: launches so far} over ``KERNELS``, counted by the library
    where it launches each kernel: which kernels the calls went to."""
    lib = _library()
    return {name: lib.ds_sparse_kernel_launches(i) for i, name in enumerate(KERNELS)}


def _check_inputs(q, k, v, cols, counts, block):
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != q {tuple(q.shape)}")
    reason = unsupported_reason(tuple(q.shape), block,
                                on_cuda=q.device.type == "cuda")
    if reason:
        raise ValueError(f"sparse_mha cannot take these shapes: {reason}")
    B, H, S, D = q.shape
    nq = S // block
    if cols.dim() != 3 or tuple(cols.shape[:2]) != (H, nq) or \
            tuple(counts.shape) != (H, nq):
        raise ValueError(f"cols {tuple(cols.shape)} / counts "
                         f"{tuple(counts.shape)} must be [{H}, {nq}, C] / "
                         f"[{H}, {nq}]")


def sparse_mha_fwd(q, k, v, cols, counts, block, causal=False, scale=None, order=None):
    """Block-sparse attention forward over compacted lists -> [B, H, S, D].

    CUDA tensors launch ``ds_block_sparse_fwd`` (counted in
    ``sparse_mha_fwd.launches``) on the route's kernel (``kernel_route``);
    the tensor-core kernel walks ``order`` (``work_order`` of the counts as
    an int32 tensor on q's device; read from ``counts`` on the host when not
    given), and inputs TMA cannot read in place are copied into aligned
    tensors first. CPU tensors run the plain version."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"sparse_mha_fwd runs on CUDA or CPU tensors, got {q.device}")
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    _check_inputs(q, k, v, cols, counts, block)
    if q.device.type == "cpu":
        return sparse_mha_fwd_reference(q, k, v, cols, counts, block, causal, scale)
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPE_CODES)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dim")
    for name, t in (("cols", cols), ("counts", counts)):
        if t.device != q.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {q.device}")
    B, H, S, D = q.shape
    wgmma = kernel_route(q.dtype, block, D) == "fwd_wgmma"
    if wgmma:
        from deepspeed_tpu_torch.ops.flash_attention import _tma_inputs
        q, k, v = _tma_inputs(q, k, v)
        if order is None:
            order = torch.from_numpy(work_order(counts.cpu().numpy())).to(q.device)
        if order.device != q.device or order.dtype != torch.int32 or \
                tuple(order.shape) != (H * (S // block),):
            raise ValueError(f"order must be an int32 [{H * (S // block)}] tensor on {q.device}")
    dh = q.shape[-1]
    out = torch.empty(B, H, S, dh, dtype=q.dtype, device=q.device)
    p = _SparseParams(B=B, H=H, S=S, dh=dh, block=block, nq=S // block,
                      C=cols.shape[-1], causal=int(bool(causal)), scale=scale)
    p.q, p.k, p.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    p.cols, p.counts, p.out = cols.data_ptr(), counts.data_ptr(), out.data_ptr()
    p.order = order.data_ptr() if wgmma else None
    p.q_sb, p.q_sh, p.q_ss = q.stride()[:3]
    p.k_sb, p.k_sh, p.k_ss = k.stride()[:3]
    p.v_sb, p.v_sh, p.v_ss = v.stride()[:3]
    lib = _library()
    rc = lib.ds_block_sparse_fwd(ctypes.byref(p), _DTYPE_CODES[q.dtype],
                                 torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"ds_block_sparse_fwd kernel launch failed: "
                           f"{lib.ds_block_sparse_error_string(rc).decode()}")
    sparse_mha_fwd.launches += 1
    return out if dh == D else out[..., :D].contiguous()


sparse_mha_fwd.launches = 0


def reset_launch_counts():
    sparse_mha_fwd.launches = 0


# ---------------------------------------------------------------------------
# backward: blockwise recompute, one query block at a time
# ---------------------------------------------------------------------------

def _query_block(qi, kg, vg, valid, scale):
    """``blockwise_sparse_attention``'s step for one query block over its
    gathered keys: logits in q's dtype, ``finfo.min`` where ``valid`` [H, block
    | 1, L] is False, an fp32 softmax, rows with no valid key zeroed, an fp32
    PV product cast to q's dtype."""
    logits = torch.einsum("bhqd,bhkd->bhqk", qi, kg) * scale
    logits = torch.where(valid[None], logits, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1)
    probs = probs * valid.any(-1, keepdim=True)[None]
    return torch.einsum("bhqk,bhkd->bhqd", probs, vg.float()).to(qi.dtype)


def _blockwise_grads(q, k, v, g, cols, counts, block, causal, scale):
    """(dq, dk, dv) of ``blockwise_sparse_attention`` at (q, k, v) against
    the output gradient ``g``. Query block i recomputes its masked softmax
    over the keys of its enabled blocks only (the others carry probability
    exactly 0 in the dense function, so the function and its gradient are
    the same), under ``enable_grad``, backpropagates it and frees it before
    block i + 1; dk and dv accumulate in fp32 and round once."""
    B, H, S, D = q.shape
    nq = S // block
    counts_host = counts.cpu().numpy()
    cols = cols.to(device=q.device, dtype=torch.long)
    counts = counts.to(device=q.device, dtype=torch.long)
    offs = torch.arange(block, device=q.device)
    dq = torch.zeros_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    q, k, v = q.detach(), k.detach(), v.detach()
    for i in range(nq):
        Ci = int(counts_host[:, i].max())
        if Ci == 0:
            continue                      # output 0 there: no gradient
        key_idx = (cols[:, i, :Ci, None] * block + offs).reshape(H, Ci * block)
        valid = (torch.arange(Ci, device=q.device)[None, :] <
                 counts[:, i, None]).repeat_interleave(block, dim=1)[:, None, :]
        if causal:
            qpos = i * block + offs
            valid = valid & (qpos[None, :, None] >= key_idx[:, None, :])
        gather = key_idx[None, :, :, None].expand(B, H, Ci * block, D)
        sl = slice(i * block, (i + 1) * block)
        with torch.enable_grad():
            qi = q[:, :, sl].requires_grad_()
            kg = torch.gather(k, 2, gather).requires_grad_()
            vg = torch.gather(v, 2, gather).requires_grad_()
            out = _query_block(qi, kg, vg, valid, scale)
            gq, gk, gv = torch.autograd.grad(out, (qi, kg, vg), g[:, :, sl])
        dq[:, :, sl] = gq
        dk.scatter_add_(2, gather, gk.float())
        dv.scatter_add_(2, gather, gv.float())
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _SparseMHA(torch.autograd.Function):
    """The JAX package's custom VJP: the forward is the kernel (or, with
    ``plain``, its plain version on any device); the backward recomputes the
    blockwise function block by block."""

    @staticmethod
    def forward(ctx, q, k, v, cols, counts, order, block, causal, scale, plain):
        if plain:
            out = sparse_mha_fwd_reference(q, k, v, cols, counts, block, causal, scale)
        else:
            out = sparse_mha_fwd(q, k, v, cols, counts, block, causal, scale, order)
        ctx.save_for_backward(q, k, v, cols, counts)
        ctx.opts = (block, causal, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, cols, counts = ctx.saved_tensors
        block, causal, scale = ctx.opts
        dq, dk, dv = _blockwise_grads(q, k, v, g, cols, counts, block, causal,
                                      scale)
        return dq, dk, dv, None, None, None, None, None, None, None


def sparse_mha(q, k, v, layout, block, causal=False, softmax_scale=None,
               plain=False):
    """Block-sparse attention with O(enabled blocks) fetch and compute.

    q/k/v: [B, H, S, D]; layout: [H, S/block, S/block] 0/1 numpy array.
    Raises ValueError on shapes the kernel cannot take (on the CPU,
    on shapes ``is_supported`` refuses). ``plain=True`` runs the kernel's
    plain version on any device: the yardstick a kernel-backed run is
    compared with, never the training path."""
    reason = unsupported_reason(tuple(q.shape), block,
                                on_cuda=q.device.type == "cuda" and not plain)
    if reason is not None:
        raise ValueError(f"sparse_mha: {reason}")
    scale = float(softmax_scale if softmax_scale is not None
                  else q.shape[-1] ** -0.5)
    cols, counts, order = _schedule(layout, causal, block, q.device)
    return _SparseMHA.apply(q, k, v, cols, counts, order, int(block), bool(causal),
                            scale, bool(plain))

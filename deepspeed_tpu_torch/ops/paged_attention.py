"""Paged (blocked-flash) attention for the ragged serving engine.

Port of the TPU kernel ``deepspeed_tpu/ops/pallas/paged_attention.py``
(``paged_mha``). ``paged_mha`` launches the hand-written Hopper kernel
``csrc/paged_attention.cu`` on CUDA tensors and counts each launch in
``paged_mha.launches``; on CPU tensors it runs ``paged_mha_reference``, the
kernel's plain PyTorch version. A CUDA tensor never reaches the plain version
through ``paged_mha``: what the kernel cannot take raises.

Layouts (the JAX package's): q [S, Q, H, Dh] (Q = new-token budget, 1 for
pure decode); k/v pools of one layer [NB, KV, bs, Dh]; block_tables [S, MB]
int32; seen [S] and q_len [S] int32. The output has q's shape and dtype.
GQA: ``rep = H // KV`` query heads share one kv head. A key at position
``kpos`` is visible to query token ``qi`` iff ``kpos <= seen + qi`` (and
``kpos > seen + qi - window`` with a window). int8 pools come with fp32
per-token scale pools [NB, KV, 1, bs]. Rows ``qi >= q_len`` are zero.
"""

import ctypes

import torch

NEG_INF = -1e9

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def unsupported_reason(q_shape, pool_shape):
    """Why the kernel cannot take these shapes, or None when it can."""
    _, _, H, Dh = q_shape
    _, KV, bs, pool_dh = pool_shape
    if KV < 1 or H % KV:
        return f"H={H} is not a multiple of KV={KV}"
    if Dh != pool_dh:
        return f"q head dim {Dh} != pool head dim {pool_dh}"
    if Dh % 16 or not 16 <= Dh <= 256:
        return f"head dim {Dh} is not a multiple of 16 in [16, 256]"
    if bs < 1:
        return f"block size {bs} < 1"
    return None


def is_supported(q_shape, pool_shape):
    return unsupported_reason(q_shape, pool_shape) is None


def paged_mha_reference(q, k_pool, v_pool, block_tables, seen, q_len, *,
                        k_scale=None, v_scale=None, softmax_scale=None,
                        window=None):
    """Plain PyTorch version of the kernel: the port of the JAX package's
    ``_paged_attention_dense`` (``inference/v2/model_implementations/
    llama.py:127``) — gather every page of the table, dequantize int8 pages
    with their scales, mask with the finite ``NEG_INF``, softmax in fp32 —
    extended to zero the rows ``qi >= q_len``."""
    S, Q, H, Dh = q.shape
    _, KV, bs, _ = k_pool.shape
    MB = block_tables.shape[1]
    rep = H // KV
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    bt = block_tables.long()
    keys, vals = k_pool[bt].float(), v_pool[bt].float()   # [S, MB, KV, bs, Dh]
    if k_scale is not None:
        # scale rows [S, MB, KV, 1, bs] -> per-token column [..., bs, 1]
        keys = keys * k_scale[bt].transpose(-1, -2)
        vals = vals * v_scale[bt].transpose(-1, -2)
    keys = keys.permute(0, 2, 1, 3, 4).reshape(S, KV, MB * bs, Dh)
    vals = vals.permute(0, 2, 1, 3, 4).reshape(S, KV, MB * bs, Dh)
    qg = q.float().reshape(S, Q, KV, rep, Dh)
    logits = torch.einsum("sqkrd,sktd->skrqt", qg, keys) * scale
    kpos = torch.arange(MB * bs, device=q.device)
    tok = torch.arange(Q, device=q.device)
    qpos = seen.long()[:, None] + tok[None, :]                # [S, Q]
    visible = kpos[None, None, :] <= qpos[:, :, None]         # [S, Q, T]
    if window:
        visible &= kpos[None, None, :] > (qpos - window)[:, :, None]
    logits = torch.where(visible[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("skrqt,sktd->sqkrd", probs, vals).reshape(S, Q, H, Dh)
    live = tok[None, :] < q_len.long()[:, None]
    return torch.where(live[:, :, None, None], out, 0.0).to(q.dtype)


def _library():
    from deepspeed_tpu_torch.ops import cuda_build
    lib = cuda_build.load("paged_attention")
    if lib.ds_paged_mha.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ds_paged_mha.argtypes = [p] * 9 + [i] * 10 + [ctypes.c_float, i, p]
        lib.ds_paged_mha.restype = ctypes.c_int
        lib.ds_cuda_error_string.argtypes = [i]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_args(q, k_pool, v_pool, block_tables, seen, q_len, k_scale,
                     v_scale):
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_tables": block_tables, "seen": seen, "q_len": q_len}
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    quantized = k_scale is not None
    if quantized:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPE_CODES)}")
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"need q [S,Q,H,Dh] and pools [NB,KV,bs,Dh], got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    reason = unsupported_reason(q.shape, k_pool.shape)
    if reason:
        raise ValueError(f"paged_mha kernel cannot take these shapes: {reason}")
    pool_dtype = torch.int8 if quantized else q.dtype
    if k_pool.dtype != pool_dtype or v_pool.dtype != pool_dtype:
        raise TypeError(f"pools must be {pool_dtype}, got {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    NB, KV, bs, _ = k_pool.shape
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or tuple(t.shape) != (NB, KV, 1, bs):
                raise ValueError(f"{name} must be float32 [{NB},{KV},1,{bs}],"
                                 f" got {t.dtype} {tuple(t.shape)}")
    S = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != S:
        raise ValueError(f"block_tables must be [S={S}, MB], got "
                         f"{tuple(block_tables.shape)}")
    for name in ("block_tables", "seen", "q_len"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tensors[name].dtype}")
    if tuple(seen.shape) != (S,) or tuple(q_len.shape) != (S,):
        raise ValueError(f"seen and q_len must be [S={S}]")
    for name in ("k_pool", "v_pool"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (page loads "
                             f"are 16 bytes wide)")


def paged_mha(q, k_pool, v_pool, block_tables, seen, q_len, *,
              k_scale=None, v_scale=None, softmax_scale=None, window=None):
    """Blocked-flash attention over paged KV. See the module docstring.

    CUDA tensors launch the sm_90a kernel (``paged_mha.launches`` counts
    each launch); CPU tensors run ``paged_mha_reference``."""
    if q.device.type == "cpu":
        return paged_mha_reference(q, k_pool, v_pool, block_tables, seen,
                                   q_len, k_scale=k_scale, v_scale=v_scale,
                                   softmax_scale=softmax_scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_mha runs on CUDA or CPU tensors, got {q.device}")
    _check_cuda_args(q, k_pool, v_pool, block_tables, seen, q_len, k_scale,
                     v_scale)
    out = torch.empty_like(q)
    S, Q, H, Dh = q.shape
    if S == 0 or Q == 0:
        return out
    NB, KV, bs, _ = k_pool.shape
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    quantized = k_scale is not None
    lib = _library()
    rc = lib.ds_paged_mha(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        block_tables.data_ptr(), seen.data_ptr(), q_len.data_ptr(),
        out.data_ptr(), S, Q, H, KV, NB, bs, block_tables.shape[1], Dh,
        _DTYPE_CODES[q.dtype], int(quantized), float(scale),
        int(window) if window else 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"paged_mha kernel launch failed: "
                           f"{lib.ds_cuda_error_string(rc).decode()}")
    paged_mha.launches += 1
    return out


paged_mha.launches = 0

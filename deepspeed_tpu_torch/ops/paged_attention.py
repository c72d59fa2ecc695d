"""Paged (blocked-flash) attention for the ragged serving engine.

Port of the TPU kernel ``deepspeed_tpu/ops/pallas/paged_attention.py``
(``paged_mha``). ``paged_mha`` launches the hand-written Hopper kernel
``csrc/paged_attention.cu`` on CUDA tensors and counts each launch in
``paged_mha.launches``; on CPU tensors it runs ``paged_mha_reference``, the
kernel's plain PyTorch version. A CUDA tensor never reaches the plain version
through ``paged_mha``: what the kernel cannot take raises. The source routes
each call (``kernel_route``; ``kernel_launches`` reads the library's tally of
what each call launched): bf16/fp16 q with fp pools at head width 64 or 128
and a block size that is a multiple of 16 dividing 64, or a multiple of 64,
to ``wgmma`` (tensor cores); fp32, int8 pools and other widths to ``simt``
(CUDA cores). Both round p to v's dtype before P.V for bf16/fp16 pools, as
the TPU kernel rounds it, and keep p in fp32 for int8 and fp32 pools.
``paged_mha_kernel_form`` is the plain version at the TPU kernel's rounding
points, page by page, for the tests and checks; the plain version
``paged_mha_reference`` keeps p in fp32, so a comparison with it adds
``tests/flash_rounding.py`` ``paged_flip_slack`` wherever p rounds.

Layouts (the JAX package's): q [S, Q, H, Dh] (Q = new-token budget, 1 for
pure decode); k/v pools of one layer [NB, KV, bs, Dh]; block_tables [S, MB]
int32; seen [S] and q_len [S] int32. The output has q's shape and dtype.
GQA: ``rep = H // KV`` query heads share one kv head. A key at position
``kpos`` is visible to query token ``qi`` iff ``kpos <= seen + qi`` (and
``kpos > seen + qi - window`` with a window). int8 pools come with fp32
per-token scale pools [NB, KV, 1, bs]. Rows ``qi >= q_len`` are zero.
"""

import ctypes
import functools

import torch

NEG_INF = -1e9
KERNELS = ("simt", "wgmma")      # the source's enum Kernel, in order
KEY_TILE = 64                    # keys per tile and query rows per item of wgmma
MAX_SPLITS = 16

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


def rounds_p(dtype, quantized):
    """Whether the kernel rounds p to v's dtype before P.V, on either
    route: bf16/fp16 q with fp pools."""
    return dtype in (torch.bfloat16, torch.float16) and not quantized


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


def paged_mha_kernel_form(q, k_pool, v_pool, block_tables, seen, q_len, *,
                          k_scale=None, v_scale=None, softmax_scale=None,
                          window=None):
    """The plain version at the TPU kernel's rounding points
    (``deepspeed_tpu/ops/pallas/paged_attention.py`` ``_kernel``, :67-116):
    the pages of each sequence in order, while any of its keys are live,
    with the running maximum m and sum l in fp32; q.k on q's dtype with
    fp32 sums (int8 k widened exactly), scaled, then the k scale; p =
    exp(s - m) rounded to v's dtype before P.V for fp pools, p times the v
    scale with v in fp32 for int8 pools. Rows ``qi >= q_len`` are 0. For
    the tests and checks; ``paged_mha`` on CPU tensors runs
    ``paged_mha_reference``."""
    return _paged_form(q, k_pool, v_pool, block_tables, seen, q_len, k_scale, v_scale,
                       softmax_scale, window, lambda p, v: p.to(v.dtype).float())


def _paged_form(q, k_pool, v_pool, block_tables, seen, q_len, k_scale, v_scale,
                softmax_scale, window, round_p):
    """``paged_mha_kernel_form`` with fp pools' p passed through
    ``round_p(p, v)`` before P.V."""
    S, Q, H, Dh = q.shape
    _, KV, bs, _ = k_pool.shape
    MB = block_tables.shape[1]
    rep, R = H // KV, H // KV * Q
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    quantized = k_scale is not None
    dev = q.device
    # rows (rep, Q) of each (sequence, kv head), as the TPU kernel groups them
    qg = q.reshape(S, Q, KV, rep, Dh).permute(0, 2, 3, 1, 4).reshape(S, KV, R, Dh).float()
    qpos = seen.long()[:, None] + (torch.arange(R, device=dev) % Q)[None, :]   # [S, R]
    total = seen.long() + q_len.long()
    bt = block_tables.long()
    m = torch.full((S, KV, R, 1), NEG_INF, device=dev)
    l = torch.zeros(S, KV, R, 1, device=dev)
    acc = torch.zeros(S, KV, R, Dh, device=dev)
    for j in range(MB):
        run = (j * bs < total)[:, None, None, None]
        if not run.any():
            break
        k, v = k_pool[bt[:, j]].float(), v_pool[bt[:, j]]       # [S, KV, bs, Dh]
        s = torch.einsum("skrd,sktd->skrt", qg, k) * scale
        if quantized:
            s = s * k_scale[bt[:, j]]                          # [S, KV, 1, bs]
        kpos = j * bs + torch.arange(bs, device=dev)
        visible = kpos[None, None, :] <= qpos[:, :, None]
        if window:
            visible &= kpos[None, None, :] > (qpos - window)[:, :, None]
        s = torch.where(visible[:, None], s, NEG_INF)
        m_cur = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur)
        l_cur = alpha * l + p.sum(-1, keepdim=True)
        if quantized:
            pv = torch.einsum("skrt,sktd->skrd", p * v_scale[bt[:, j]], v.float())
        else:
            pv = torch.einsum("skrt,sktd->skrd", round_p(p, v), v.float())
        m = torch.where(run, m_cur, m)
        l = torch.where(run, l_cur, l)
        acc = torch.where(run, acc * alpha + pv, acc)
    out = acc / torch.where(l == 0, 1.0, l)
    out = out.reshape(S, KV, rep, Q, Dh).permute(0, 3, 1, 2, 4).reshape(S, Q, H, Dh)
    live = torch.arange(Q, device=dev)[None, :] < q_len.long()[:, None]
    return torch.where(live[:, :, None, None], out, 0.0).to(q.dtype)


def split_count(S, Q, H, KV, bs, MB, sm_count):
    """Key splits of the tensor-core kernel, from the shapes alone (no host
    sync on seen): only where every (sequence, kv head) is one item of at
    most KEY_TILE rows (a decode round) and those S x KV items would not
    fill the card's 2 x sm_count resident blocks four times over, as many
    as make about that many items, each of at least two key tiles of the
    block table's width, at most MAX_SPLITS."""
    items, slots = S * KV, 2 * sm_count
    if -(-(H // KV) * Q // KEY_TILE) > 1 or items >= 4 * slots:
        return 1
    key_tiles = -(-MB * bs // KEY_TILE)
    return max(1, min(MAX_SPLITS, -(-4 * slots // items), key_tiles // 2))


def split_ranges(seen, q_len, Q, rep, window, splits, key_tiles):
    """[(first, end)] key-tile ranges of one (sequence, kv head) item's
    splits, as the tensor-core kernel cuts them: split i takes the 64-key
    tiles [i * per, (i + 1) * per) of the block table's ``key_tiles``
    (per = ceil(key_tiles / splits), the last split all that follow),
    clipped to the tiles from the first key the item's live rows can see to
    the last (empty ranges where nothing is left). The boundaries depend on
    the call's shape alone, not on the item's rows. [] without a live
    row."""
    qis = [g % Q for g in range(rep * Q) if g % Q < q_len]
    if not qis:
        return []
    key_end = seen + max(qis) + 1
    key_begin = max(0, seen + min(qis) - window + 1) if window else 0
    first, last = key_begin // KEY_TILE, -(-key_end // KEY_TILE)
    per = -(-key_tiles // splits)
    cut = [min(max(first, i * per), last) for i in range(splits)] + [last]
    return list(zip(cut[:-1], cut[1:]))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=4096)
def _splits(code, quantized, S, Q, H, KV, Dh, bs, MB, device_index):
    """The key splits of a call: ``split_count`` on the tensor-core route
    (``ds_paged_route``), 1 elsewhere; remembered per shape, so that a
    serving round asks the library once."""
    if KERNELS[_library().ds_paged_route(code, quantized, Dh, bs)] != "wgmma":
        return 1
    return split_count(S, Q, H, KV, bs, MB, _sm_count(device_index))


def _library():
    from deepspeed_tpu_torch.ops import cuda_build
    lib = cuda_build.load("paged_attention")
    if lib.ds_paged_mha.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ds_paged_mha.argtypes = [p] * 11 + [i] * 10 + [ctypes.c_float, i, i, p]
        lib.ds_paged_mha.restype = ctypes.c_int
        lib.ds_cuda_error_string.argtypes = [i]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
        lib.ds_paged_route.argtypes = [i] * 4
        lib.ds_paged_route.restype = i
        lib.ds_paged_kernel_launches.argtypes = [i]
        lib.ds_paged_kernel_launches.restype = ctypes.c_longlong
    return lib


def kernel_route(dtype, quantized, dh, bs):
    """The kernel (a name of ``KERNELS``) that q of ``dtype`` over int8
    (``quantized``) or fp pools of head width ``dh`` and block size ``bs``
    launches, as the kernel source decides it (``ds_paged_route``). Builds
    the library."""
    k = _library().ds_paged_route(_DTYPE_CODES[dtype], int(quantized), dh, bs)
    if k < 0:
        raise ValueError(f"no paged attention kernel takes {dtype} at head width "
                         f"{dh}, block size {bs}")
    return KERNELS[k]


def kernel_launches():
    """{kernel: launches so far} over ``KERNELS``, counted by the library
    where it launches each kernel: which kernels the calls went to."""
    lib = _library()
    return {name: lib.ds_paged_kernel_launches(i) for i, name in enumerate(KERNELS)}


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

    CUDA tensors launch the route's sm_90a kernel (``paged_mha.launches``
    counts the calls, ``kernel_launches`` the kernels); CPU tensors run
    ``paged_mha_reference``."""
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
    MB = block_tables.shape[1]
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    quantized = k_scale is not None
    lib = _library()
    code = _DTYPE_CODES[q.dtype]
    splits = _splits(code, int(quantized), S, Q, H, KV, Dh, bs, MB, q.device.index)
    o_ws = ml_ws = ws = None
    if splits > 1:
        # one allocation: o [splits, rows, Dh], then m and l [splits, rows, 2]
        n_o = splits * S * H * Q * Dh
        ws = torch.empty(n_o + splits * S * H * Q * 2, dtype=torch.float32, device=q.device)
        o_ws, ml_ws = ws.data_ptr(), ws.data_ptr() + n_o * 4
    rc = lib.ds_paged_mha(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        block_tables.data_ptr(), seen.data_ptr(), q_len.data_ptr(),
        out.data_ptr(), o_ws, ml_ws, S, Q, H, KV, NB, bs, MB, Dh,
        code, int(quantized), float(scale), int(window) if window else 0, splits,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"paged_mha kernel launch failed: "
                           f"{lib.ds_cuda_error_string(rc).decode()}")
    paged_mha.launches += 1
    return out


paged_mha.launches = 0

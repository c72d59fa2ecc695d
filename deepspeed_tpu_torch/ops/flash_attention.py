"""Flash attention for training (port of ``deepspeed_tpu/ops/flash_attention.py``
and the TPU kernels of ``deepspeed_tpu/ops/pallas/flash_attention.py``).

``mha`` is the attention entry point the models call. It runs ``flash_mha``,
a ``torch.autograd.Function`` whose forward launches ``flash_mha_fwd`` and
whose backward launches ``flash_mha_bwd_dq`` and ``flash_mha_bwd_dkv``. On
CUDA tensors each of those launches its hand-written Hopper kernel
(``csrc/flash_attention.cu``) and counts the launch in ``<fn>.launches``; on
CPU tensors it runs its plain PyTorch version (``*_reference`` below). A CUDA
tensor never reaches a plain version through these wrappers: what the kernels
cannot take raises. ``mha_reference`` is the JAX package's dense XLA
attention, kept as a function; ``mha`` never falls back to it.

The route is chosen by dtype and head width, in the kernel source
(``kernel_route`` reads it; ``kernel_launches`` counts what each call
launched): bf16/fp16 run the tensor-core kernels (``wgmma`` fed by a TMA ring
in shared memory), fp32 the SIMT kernels (fp32 FMAs: ``wgmma`` has no exact
fp32 product). dk/dv keeps p and ds in fp32 on the tensor cores by a split
product (each split into a 16-bit hi and lo part, both multiplied); at head
width 256, whose dK and dV accumulators do not fit a warpgroup's registers,
it runs its SIMT kernel. The forward's key tile, which decides where p
rounds, is ``FWD_BLOCK_K`` per dtype and head width.

Layouts are the JAX package's: q [B, Tq, H, Dh], k/v [B, Tk, KV, Dh] with
H % KV == 0 (query head h reads kv head h // (H // KV)); the output has q's
shape; lse and delta are fp32 [B, H, Tq]. ``causal`` keeps key j for query i
iff j <= i + off with off = Tk - Tq; ``window`` keeps j > i + off - window;
``segment_ids`` (q_ids [B, Tq], kv_ids [B, Tk], or one [B, T] array) keeps
equal ids; ``bias`` [B|1, H|1, Tq, Tk] is added to the scaled logits and gets
no gradient. Masked logits take the finite ``NEG_INF``.

The kernels mask the ragged edge themselves, so ``mha`` does not pad lengths
to a multiple of 128 as the JAX ``mha`` does for its TPU kernel. Rows with no
visible key hold the mean of V over the key tiles the kernel visits (see the
kernel source); the dense plain versions average over all keys there. Parity
is defined on rows with at least one visible key.
"""

import ctypes
from typing import Optional

import torch

NEG_INF = -1e9  # large finite; -inf breaks softmax rows that are fully masked

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def mha_reference(q, k, v, bias=None, causal=True, softmax_scale=None,
                  window=None, segment_ids=None):
    """Plain attention, the JAX package's ``mha_reference``: fp32 logits,
    finite ``NEG_INF`` masks, probabilities cast to q's dtype before PV."""
    *_, H, Dh = q.shape
    KV = k.shape[2]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    scale = softmax_scale if softmax_scale is not None else 1.0 / (Dh ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if bias is not None:
        logits = logits + bias
    mask = _visibility(q.shape[1], k.shape[1], causal, window, segment_ids,
                       q.device)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _visibility(Tq, Tk, causal, window, segment_ids, device):
    """Bool mask broadcastable to [B, 1, Tq, Tk], or None when all keys are
    visible."""
    mask = None
    off = Tk - Tq
    if causal or window is not None:
        qpos = torch.arange(Tq, device=device)[:, None]
        kpos = torch.arange(Tk, device=device)[None, :]
        mask = torch.ones(Tq, Tk, dtype=torch.bool, device=device)
        if causal:
            mask &= qpos + off >= kpos
        if window is not None:
            mask &= kpos > qpos + off - window
    if segment_ids is not None:
        q_seg, kv_seg = _segment_pair(segment_ids)
        same = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
        mask = same if mask is None else mask & same
    return mask


def _segment_pair(segment_ids):
    if isinstance(segment_ids, (tuple, list)):
        return tuple(segment_ids)
    return segment_ids, segment_ids


def unsupported_reason(q_shape, k_shape, bias_shape=None, window=None,
                       segment_ids_shape=None):
    """None if the kernels can take these shapes, else a human reason. Unlike
    the TPU kernel, any sequence lengths are accepted."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return f"expected 4D [B,T,H,Dh] tensors, got q={q_shape} k={k_shape}"
    B, tq, H, dh = q_shape
    kb, tk, kv, kdh = k_shape
    if kb != B or kdh != dh:
        return f"k {tuple(k_shape)} does not match q {tuple(q_shape)}"
    if kv == 0 or H % kv != 0:
        return f"q heads {H} not a multiple of kv heads {kv}"
    if not 0 < dh <= 256:
        return f"head dim {dh} not in [1, 256]"
    if window is not None and int(window) <= 0:
        return f"sliding window must be positive, got {window}"
    if bias_shape is not None:
        if len(bias_shape) != 4:
            return f"bias must be 4D [B|1, H|1, Tq, Tk], got {bias_shape}"
        bb, bh, btq, btk = bias_shape
        if (btq, btk) != (tq, tk) or bb not in (1, B) or bh not in (1, H):
            return (f"bias {tuple(bias_shape)} not broadcastable to "
                    f"[{B}|1, {H}|1, {tq}, {tk}]")
    if segment_ids_shape is not None:
        qs, ks = segment_ids_shape
        if tuple(qs) != (B, tq) or tuple(ks) != (B, tk):
            return (f"segment ids {tuple(qs)}/{tuple(ks)} must be "
                    f"[B={B}, Tq={tq}] and [B={B}, Tk={tk}]")
    return None


# ---------------------------------------------------------------------------
# plain versions of the three kernels
# ---------------------------------------------------------------------------

def _masked_logits(q, k, b, bias, causal, scale, window, segment_ids):
    """fp32 logits [H, Tq, Tk] of batch row b, masked with NEG_INF."""
    H, KV = q.shape[2], k.shape[2]
    kf = k[b].float().repeat_interleave(H // KV, dim=1)
    s = torch.einsum("qhd,khd->hqk", q[b].float(), kf) * scale
    if bias is not None:
        s = s + bias[b if bias.shape[0] > 1 else 0].float()
    seg = None
    if segment_ids is not None:
        qs, ks = _segment_pair(segment_ids)
        seg = (qs[b:b + 1], ks[b:b + 1])
    mask = _visibility(q.shape[1], k.shape[1], causal, window, seg, q.device)
    if mask is not None:
        s = torch.where(mask.reshape(-1, *mask.shape[-2:]), s, NEG_INF)
    return s


def staged_width(dh):
    """Columns a head of width ``dh`` is staged as in the kernels."""
    return 64 if dh <= 64 else 128 if dh <= 128 else 256


# Keys per tile of the forward kernel, by (dtype, staged head width). The
# forward rounds p = exp(s - m) to v's dtype with m the running maximum over
# the tiles seen so far, as the TPU kernel does over its blocks; the plain
# version takes the same tiles so that the two differ by the output's one
# rounding, not by where p rounds. bf16/fp16 run the tensor-core kernel
# (128-key tiles, 64 at head width 256, where its accumulators need the
# registers), fp32 the SIMT kernel (64). Mirrored by ``fwd_block_k`` in
# csrc/flash_attention.cu, exposed as ``ds_flash_fwd_block_k``.
FWD_BLOCK_K = {
    (torch.bfloat16, 64): 128, (torch.bfloat16, 128): 128, (torch.bfloat16, 256): 64,
    (torch.float16, 64): 128, (torch.float16, 128): 128, (torch.float16, 256): 64,
    (torch.float32, 64): 64, (torch.float32, 128): 64, (torch.float32, 256): 64,
}


def fwd_block_k(dtype, dh):
    """Keys per tile of the forward kernel for inputs of ``dtype`` and head
    width ``dh``: the tiles against whose running maximum p is rounded."""
    return FWD_BLOCK_K[(dtype, staged_width(dh))]


def flash_mha_fwd_reference(q, k, v, bias=None, segment_ids=None, causal=True,
                            softmax_scale=None, window=None):
    """Plain version of the forward kernel -> (out, lse [B, H, Tq] fp32),
    one batch row at a time: p = exp(s - m_t) with m_t the running maximum
    up to the key's tile of ``fwd_block_k(q.dtype, Dh)`` keys, rounded to
    v's dtype and rescaled by exp(m_t - m) in fp32 before PV (the kernel's
    alpha); l summed from the unrounded p; out = acc / l_safe;
    lse = m + log(max(l, 1e-30))."""
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    rep = H // k.shape[2]
    block_k = fwd_block_k(q.dtype, Dh)
    n_tiles = -(-Tk // block_k)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    for b in range(B):
        s = _masked_logits(q, k, b, bias, causal, scale, window, segment_ids)
        tiles = torch.nn.functional.pad(s, (0, n_tiles * block_k - Tk),
                                        value=float("-inf"))
        tile_max = tiles.view(H, Tq, n_tiles, block_k).amax(-1)
        running = torch.clamp(torch.cummax(tile_max, dim=-1).values, min=NEG_INF)
        m_t = running.repeat_interleave(block_k, dim=-1)[..., :Tk]
        m = running[..., -1:]
        p = torch.exp(s - m_t)
        l = (p * torch.exp(m_t - m)).sum(-1, keepdim=True)
        p_v = p.to(v.dtype).float() * torch.exp(m_t - m)
        vf = v[b].float().repeat_interleave(rep, dim=1)
        acc = torch.einsum("hqk,khd->qhd", p_v, vf)
        l_safe = torch.where(l == 0, 1.0, l)
        out[b] = (acc / l_safe.squeeze(-1).transpose(0, 1)[..., None]).to(q.dtype)
        lse[b] = (m + torch.log(torch.clamp(l, min=1e-30))).squeeze(-1)
    return out, lse


def flash_mha_bwd_dq_reference(q, k, v, dout, lse, delta, bias=None,
                               segment_ids=None, causal=True,
                               softmax_scale=None, window=None):
    """Plain version of the dq kernel: p = exp(s - lse), dp = dO.V^T in fp32,
    ds = p (dp - delta) scale rounded to k's dtype, dq = ds.K."""
    B, Tq, H, Dh = q.shape
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    rep = H // k.shape[2]
    dq = torch.empty_like(q)
    for b in range(B):
        s = _masked_logits(q, k, b, bias, causal, scale, window, segment_ids)
        p = torch.exp(s - lse[b][..., None])
        vf = v[b].float().repeat_interleave(rep, dim=1)
        dp = torch.einsum("qhd,khd->hqk", dout[b].float(), vf)
        ds = (p * (dp - delta[b][..., None]) * scale).to(k.dtype).float()
        kf = k[b].float().repeat_interleave(rep, dim=1)
        dq[b] = torch.einsum("hqk,khd->qhd", ds, kf).to(q.dtype)
    return dq


def flash_mha_bwd_dkv_reference(q, k, v, dout, lse, delta, bias=None,
                                segment_ids=None, causal=True,
                                softmax_scale=None, window=None):
    """Plain version of the dk/dv kernel: p, dp and ds in fp32,
    dv = p^T.dO and dk = ds^T.Q, summed over each kv group's query heads in
    fp32 before the one rounding to k's dtype."""
    B, Tq, H, Dh = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    rep = H // KV
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for b in range(B):
        s = _masked_logits(q, k, b, bias, causal, scale, window, segment_ids)
        p = torch.exp(s - lse[b][..., None])
        do = dout[b].float()
        vf = v[b].float().repeat_interleave(rep, dim=1)
        dp = torch.einsum("qhd,khd->hqk", do, vf)
        ds = p * (dp - delta[b][..., None]) * scale
        dv_h = torch.einsum("hqk,qhd->khd", p, do)
        dk_h = torch.einsum("hqk,qhd->khd", ds, q[b].float())
        dv[b] = dv_h.reshape(Tk, KV, rep, Dh).sum(2).to(v.dtype)
        dk[b] = dk_h.reshape(Tk, KV, rep, Dh).sum(2).to(k.dtype)
    return dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

class _FlashParams(ctypes.Structure):
    """Mirror of ``Params`` in csrc/flash_attention.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "q", "k", "v", "dout", "bias", "qseg", "kseg", "lse", "delta", "out",
        "lse_out", "dq", "dk", "dv")]
        + [(n, ctypes.c_longlong) for n in (
            "q_sb", "q_st", "q_sh", "k_sb", "k_st", "k_sh", "v_sb", "v_st",
            "v_sh", "do_sb", "do_st", "do_sh", "bias_sb", "bias_sh")]
        + [(n, ctypes.c_int) for n in (
            "B", "Tq", "Tk", "H", "KV", "dh", "causal", "window")]
        + [("scale", ctypes.c_float)])


def _library():
    from deepspeed_tpu_torch.ops import cuda_build
    lib = cuda_build.load("flash_attention")
    if lib.ds_flash_fwd.argtypes is None:
        args = [ctypes.POINTER(_FlashParams), ctypes.c_int, ctypes.c_void_p]
        for fn in (lib.ds_flash_fwd, lib.ds_flash_bwd_dq, lib.ds_flash_bwd_dkv):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.ds_flash_fwd_block_k.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ds_flash_fwd_block_k.restype = ctypes.c_int
        lib.ds_flash_route.argtypes = [ctypes.c_int] * 3
        lib.ds_flash_route.restype = ctypes.c_int
        lib.ds_flash_kernel_launches.argtypes = [ctypes.c_int]
        lib.ds_flash_kernel_launches.restype = ctypes.c_longlong
        lib.ds_flash_error_string.argtypes = [ctypes.c_int]
        lib.ds_flash_error_string.restype = ctypes.c_char_p
    return lib


def kernel_block_k(dtype, dh):
    """The forward kernel's own key tile for ``dtype`` and head width ``dh``
    (``ds_flash_fwd_block_k``), to hold ``FWD_BLOCK_K`` to. Builds the
    library."""
    return _library().ds_flash_fwd_block_k(_DTYPE_CODES[dtype], int(dh))


_WHICH = {"fwd": 0, "dq": 1, "dkv": 2}
# The kernels in the order of the source's launch tally (enum Kernel).
KERNELS = ("fwd_simt", "fwd_wgmma", "dq_simt", "dq_wgmma", "dkv_simt", "dkv_wgmma")


def kernel_route(which, dtype, dh):
    """``"wgmma"`` or ``"simt"``: the kernel that ``which`` (``"fwd"``,
    ``"dq"`` or ``"dkv"``) launches for inputs of ``dtype`` and head width
    ``dh``, as the kernel source decides it (``ds_flash_route``). Builds the
    library."""
    route = _library().ds_flash_route(_WHICH[which], _DTYPE_CODES[dtype], int(dh))
    if route < 0:
        raise ValueError(f"no flash kernel takes {which} in {dtype} at head width {dh}")
    return "wgmma" if route else "simt"


def kernel_launches():
    """{kernel: launches so far} over ``KERNELS``, counted by the library
    where it launches each kernel: which kernels the calls went to."""
    lib = _library()
    return {name: lib.ds_flash_kernel_launches(i) for i, name in enumerate(KERNELS)}


def _tma_ready(t):
    """True when TMA can read ``t`` where it lies: a 16-byte aligned base,
    a head width of whole 16-byte chunks and 16-byte multiples for the
    strides of every dim longer than 1."""
    e = t.element_size()
    return (t.data_ptr() % 16 == 0 and t.shape[-1] * e % 16 == 0
            and all(st * e % 16 == 0
                    for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1))


def _tma_inputs(*tensors):
    """The tensor-core kernels' inputs: the tensors themselves when TMA can
    read all of them in place, else contiguous copies with the head width
    zero-padded to a multiple of 8 (the zero columns add nothing to q.k and
    give zero output columns, which the caller slices off)."""
    if all(_tma_ready(t) for t in tensors):
        return tensors
    pad = -tensors[0].shape[-1] % 8
    return tuple(torch.nn.functional.pad(t, (0, pad)).contiguous()
                 for t in tensors)


def _params(q, k, v, bias, segment_ids, causal, scale, window, dout=None):
    """Validated kernel parameters for CUDA tensors; keeps the tensors it
    made (fp32 bias, int32 segment ids) alive on the returned object."""
    tensors = {"q": q, "k": k, "v": v}
    if dout is not None:
        tensors["dout"] = dout
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 4D with a contiguous last dim")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPE_CODES)}")
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    seg = None if segment_ids is None else _segment_pair(segment_ids)
    reason = unsupported_reason(
        tuple(q.shape), tuple(k.shape),
        None if bias is None else tuple(bias.shape), window,
        None if seg is None else (tuple(seg[0].shape), tuple(seg[1].shape)))
    if reason:
        raise ValueError(f"flash_mha kernels cannot take these shapes: {reason}")
    B, Tq, H, Dh = q.shape
    p = _FlashParams(B=B, Tq=Tq, Tk=k.shape[1], H=H, KV=k.shape[2], dh=Dh,
                     causal=int(bool(causal)),
                     window=int(window) if window else 0, scale=float(scale))
    p.q, p.k, p.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    p.q_sb, p.q_st, p.q_sh = q.stride()[:3]
    p.k_sb, p.k_st, p.k_sh = k.stride()[:3]
    p.v_sb, p.v_st, p.v_sh = v.stride()[:3]
    if dout is not None:
        p.dout = dout.data_ptr()
        p.do_sb, p.do_st, p.do_sh = dout.stride()[:3]
    keep = []
    if bias is not None:
        bias = bias.to(device=q.device, dtype=torch.float32)
        if bias.stride(-1) != 1 or bias.stride(-2) != bias.shape[-1]:
            bias = bias.contiguous()
        keep.append(bias)
        p.bias = bias.data_ptr()
        p.bias_sb = bias.stride(0) if bias.shape[0] > 1 else 0
        p.bias_sh = bias.stride(1) if bias.shape[1] > 1 else 0
    if seg is not None:
        qs, ks = (s.to(device=q.device, dtype=torch.int32).contiguous()
                  for s in seg)
        keep += [qs, ks]
        p.qseg, p.kseg = qs.data_ptr(), ks.data_ptr()
    p._keep = keep
    return p


def _launch(fn_name, params, dtype, device):
    lib = _library()
    rc = getattr(lib, fn_name)(ctypes.byref(params), _DTYPE_CODES[dtype],
                               torch.cuda.current_stream(device).cuda_stream)
    if rc:
        raise RuntimeError(f"{fn_name} kernel launch failed: "
                           f"{lib.ds_flash_error_string(rc).decode()}")


def _check_device(q, name):
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {q.device}")


def _scale(q, softmax_scale):
    return softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5


def flash_mha_fwd(q, k, v, bias=None, segment_ids=None, causal=True,
                  softmax_scale=None, window=None):
    """Forward kernel -> (out [B, Tq, H, Dh], lse [B, H, Tq] fp32).

    CUDA tensors launch ``ds_flash_fwd`` (counted in
    ``flash_mha_fwd.launches``): the tensor-core kernel for bf16/fp16, the
    SIMT kernel for fp32 (``kernel_route``). Tensor-core inputs that TMA
    cannot read in place (a base or stride off 16 bytes, a head width not a
    multiple of 8) are first copied into aligned tensors. CPU tensors run
    the plain version."""
    _check_device(q, "flash_mha_fwd")
    if q.device.type == "cpu":
        return flash_mha_fwd_reference(q, k, v, bias, segment_ids, causal,
                                       softmax_scale, window)
    scale, dh = _scale(q, softmax_scale), q.shape[-1]
    if kernel_route("fwd", q.dtype, dh) == "wgmma":
        q, k, v = _tma_inputs(q, k, v)
    p = _params(q, k, v, bias, segment_ids, causal, scale, window)
    B, Tq, H, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    p.out, p.lse_out = out.data_ptr(), lse.data_ptr()
    _launch("ds_flash_fwd", p, q.dtype, q.device)
    flash_mha_fwd.launches += 1
    if out.shape[-1] != dh:
        out = out[..., :dh].contiguous()
    return out, lse


def flash_mha_bwd_dq(q, k, v, dout, lse, delta, bias=None, segment_ids=None,
                     causal=True, softmax_scale=None, window=None):
    """dq kernel -> dq [B, Tq, H, Dh]. lse and delta are fp32 [B, H, Tq].

    CUDA tensors launch ``ds_flash_bwd_dq`` (counted in
    ``flash_mha_bwd_dq.launches``), routed and aligned as the forward is;
    CPU tensors run the plain version."""
    _check_device(q, "flash_mha_bwd_dq")
    if q.device.type == "cpu":
        return flash_mha_bwd_dq_reference(q, k, v, dout, lse, delta, bias,
                                          segment_ids, causal, softmax_scale,
                                          window)
    scale, dh = _scale(q, softmax_scale), q.shape[-1]
    if kernel_route("dq", q.dtype, dh) == "wgmma":
        q, k, v, dout = _tma_inputs(q, k, v, dout)
    p = _params(q, k, v, bias, segment_ids, causal, scale, window, dout=dout)
    lse, delta = _rows(lse, q), _rows(delta, q)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    p.lse, p.delta, p.dq = lse.data_ptr(), delta.data_ptr(), dq.data_ptr()
    _launch("ds_flash_bwd_dq", p, q.dtype, q.device)
    flash_mha_bwd_dq.launches += 1
    if dq.shape[-1] != dh:
        dq = dq[..., :dh].contiguous()
    return dq


def flash_mha_bwd_dkv(q, k, v, dout, lse, delta, bias=None, segment_ids=None,
                      causal=True, softmax_scale=None, window=None):
    """dk/dv kernel -> (dk, dv), each [B, Tk, KV, Dh], summed over the query
    heads of each kv group.

    CUDA tensors launch ``ds_flash_bwd_dkv`` (counted in
    ``flash_mha_bwd_dkv.launches``), routed and aligned as the forward is;
    CPU tensors run the plain version."""
    _check_device(q, "flash_mha_bwd_dkv")
    if q.device.type == "cpu":
        return flash_mha_bwd_dkv_reference(q, k, v, dout, lse, delta, bias,
                                           segment_ids, causal, softmax_scale,
                                           window)
    scale, dh = _scale(q, softmax_scale), q.shape[-1]
    if kernel_route("dkv", q.dtype, dh) == "wgmma":
        q, k, v, dout = _tma_inputs(q, k, v, dout)
    p = _params(q, k, v, bias, segment_ids, causal, scale, window, dout=dout)
    lse, delta = _rows(lse, q), _rows(delta, q)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    p.lse, p.delta = lse.data_ptr(), delta.data_ptr()
    p.dk, p.dv = dk.data_ptr(), dv.data_ptr()
    _launch("ds_flash_bwd_dkv", p, q.dtype, q.device)
    flash_mha_bwd_dkv.launches += 1
    if dk.shape[-1] != dh:
        dk, dv = dk[..., :dh].contiguous(), dv[..., :dh].contiguous()
    return dk, dv


def _rows(x, q):
    B, Tq, H, _ = q.shape
    if x.dtype != torch.float32 or tuple(x.shape) != (B, H, Tq) \
            or x.device != q.device:
        raise ValueError(f"lse/delta must be float32 [{B}, {H}, {Tq}] on "
                         f"{q.device}, got {x.dtype} {tuple(x.shape)}")
    return x.contiguous()


flash_mha_fwd.launches = 0
flash_mha_bwd_dq.launches = 0
flash_mha_bwd_dkv.launches = 0


def reset_launch_counts():
    flash_mha_fwd.launches = 0
    flash_mha_bwd_dq.launches = 0
    flash_mha_bwd_dkv.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

@torch.library.custom_op("deepspeed_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: Optional[torch.Tensor], q_seg: Optional[torch.Tensor],
                 kv_seg: Optional[torch.Tensor], causal: bool, scale: float,
                 window: Optional[int], plain: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_mha_fwd`` (its plain version with ``plain``) as one
    dispatcher op, so that a selective-checkpoint policy can name its
    (out, lse), as the JAX package names ``flash_attn_out``."""
    seg = None if q_seg is None else (q_seg, kv_seg)
    fwd = flash_mha_fwd_reference if plain else flash_mha_fwd
    return fwd(q, k, v, bias, seg, causal, scale, window)


class _FlashMHA(torch.autograd.Function):
    """The JAX package's ``_flash`` custom VJP: the forward kernel saves
    (q, k, v, out, lse); the backward computes delta = rowsum(dO * O) in
    fp32 (XLA in the JAX package, one torch expression here) and launches
    the dq and dk/dv kernels. The bias and segment ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, q_seg, kv_seg, causal, scale, window, plain):
        out, lse = flash_fwd_op(q, k, v, bias, q_seg, kv_seg, causal, scale, window, plain)
        ctx.save_for_backward(q, k, v, bias, q_seg, kv_seg, out, lse)
        ctx.opts = (causal, scale, window, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, q_seg, kv_seg, out, lse = ctx.saved_tensors
        causal, scale, window, plain = ctx.opts
        seg = None if q_seg is None else (q_seg, kv_seg)
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq_fn = flash_mha_bwd_dq_reference if plain else flash_mha_bwd_dq
        dkv_fn = flash_mha_bwd_dkv_reference if plain else flash_mha_bwd_dkv
        dq = dq_fn(q, k, v, g, lse, delta, bias, seg, causal, scale, window)
        dk, dv = dkv_fn(q, k, v, g, lse, delta, bias, seg, causal, scale, window)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_mha(q, k, v, bias=None, causal=True, softmax_scale=None,
              window=None, segment_ids=None, plain=False):
    """Differentiable flash attention (see the module docstring). Raises
    ValueError on shapes the kernels cannot take, on every device.
    ``plain=True`` runs the plain versions on any device: the yardstick a
    kernel-backed run is compared with, never the training path. A
    tensor-parallel rank's empty share (no heads, the v1 engine's logits
    forward) gets its empty output without a launch."""
    if q.shape[2] == 0 and k.shape[2] == 0:
        return q.new_empty(q.shape)
    seg = None if segment_ids is None else _segment_pair(segment_ids)
    reason = unsupported_reason(
        tuple(q.shape), tuple(k.shape),
        None if bias is None else tuple(bias.shape), window,
        None if seg is None else (tuple(seg[0].shape), tuple(seg[1].shape)))
    if reason is not None:
        raise ValueError(f"flash_mha: {reason}")
    if bias is not None:
        bias = bias.detach()
    q_seg, kv_seg = (None, None) if seg is None else seg
    return _FlashMHA.apply(q, k, v, bias, q_seg, kv_seg, bool(causal),
                           float(_scale(q, softmax_scale)),
                           None if window is None else int(window), bool(plain))


def mha(q, k, v, bias=None, causal=True, softmax_scale=None, window=None,
        segment_ids=None):
    """The models' attention entry point: ``flash_mha`` on every device
    (kernels on CUDA tensors, their plain versions on CPU tensors)."""
    if window is not None and int(window) <= 0:
        raise ValueError(f"mha: sliding window must be positive or None, "
                         f"got {window}")
    return flash_mha(q, k, v, bias=bias, causal=causal,
                     softmax_scale=softmax_scale, window=window,
                     segment_ids=segment_ids)


def mha_plain(q, k, v, bias=None, causal=True, softmax_scale=None, window=None,
              segment_ids=None):
    """``mha`` through the three kernels' plain versions on any device, for
    comparing a kernel-backed forward and backward with them."""
    return flash_mha(q, k, v, bias=bias, causal=causal,
                     softmax_scale=softmax_scale, window=window,
                     segment_ids=segment_ids, plain=True)

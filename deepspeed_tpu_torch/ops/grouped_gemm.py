"""Ragged grouped-GEMM MoE expert FFN for the serving engine.

Port of ``deepspeed_tpu/ops/pallas/grouped_gemm.py`` (``topk_router``,
``moe_ffn_gmm`` / ``_moe_ffn_gmm_local``, whose three megablox ``gmm`` calls
reach ``pl.pallas_call``). ``grouped_matmul`` launches the hand-written Hopper
kernel ``csrc/grouped_gemm.cu`` on CUDA tensors and counts each launch in
``grouped_matmul.launches``; on CPU tensors it runs
``grouped_matmul_reference``, the kernel's plain PyTorch version. A CUDA
tensor never reaches the plain version through ``grouped_matmul``: what the
kernel cannot take raises.

Layouts (the JAX package's): x [T, D]; w1/w3 [E, D, F]; w2 [E, F, D]; the
router weight [D, E]; top_vals fp32 [T, k]; top_idx int [T, k]. A grouped
product takes rows ``xs [R, K]`` sorted by expert and ``group_offsets [E+1]``
int32 (``group_offsets[e]:group_offsets[e+1]`` are expert ``e``'s rows,
``group_offsets[0] == 0``, ``group_offsets[E] == R``), and returns
``xs[rows_e] @ w[e]`` for every expert, accumulated in fp32 and rounded once
to xs's dtype: megablox ``gmm(..., preferred_element_type=float32)`` followed
by ``.astype(dtype)``.

The JAX wrapper pads the rows to its 128-row tile into the last group; the
kernel here masks its ragged row, K and N edges itself, so nothing is padded.
Group sizes and offsets are computed on the device: the kernel finds each
tile's expert from ``group_offsets`` itself, so a forward costs no host sync.
``moe_ffn_gmm_rows`` (the expert-parallel per-row FFN) waits for expert
parallelism (ROADMAP B2).
"""

import ctypes

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# 16-byte loads of K- and N-contiguous rows: both widths must be multiples of
# 8 elements (16 bytes of bf16/fp16)
ALIGN = 8


def unsupported_reason(k_dim, n_dim):
    """Why the kernel cannot take a [R, K] @ [E, K, N] product, or None."""
    for name, v in (("K", k_dim), ("N", n_dim)):
        if v is None or v < 1 or v % ALIGN:
            return f"{name}={v} is not a positive multiple of {ALIGN}"
    return None


def is_supported(d_model, d_ff):
    """Whether the kernel takes both products of the expert FFN: x @ w1/w3
    contracts D and emits F, h @ w2 contracts F and emits D."""
    return unsupported_reason(d_model, d_ff) is None


def topk_router(x, gate_wg, k):
    """Mixtral top-k softmax router with renormalised gate weights.

    The routing of both dispatch paths: ``(x @ gate_wg)`` in x's dtype, then
    fp32, softmax, top-k, renormalise. Ties go to the lower expert index, as
    ``jax.lax.top_k`` does: a stable sort of the negated probabilities keeps
    equal values in index order, which ``torch.topk`` does not promise.
    Returns (top_vals fp32 [T, k], top_idx int64 [T, k])."""
    probs = torch.softmax((x @ gate_wg).float(), dim=-1)
    top_idx = torch.sort(-probs, dim=-1, stable=True).indices[:, :k]
    top_vals = torch.gather(probs, 1, top_idx)
    return top_vals / top_vals.sum(-1, keepdim=True), top_idx


def grouped_matmul_reference(xs, w, group_offsets):
    """Plain PyTorch version of the kernel: a loop over experts of
    ``xs[rows_e].float() @ w[e].float()``, cast once to xs's dtype. Reads the
    offsets on the host (one sync), which the kernel never does."""
    offs = group_offsets.tolist()
    out = torch.empty(xs.shape[0], w.shape[2], dtype=xs.dtype, device=xs.device)
    for e in range(w.shape[0]):
        lo, hi = offs[e], offs[e + 1]
        if hi > lo:
            out[lo:hi] = (xs[lo:hi].float() @ w[e].float()).to(xs.dtype)
    return out


def _library():
    from deepspeed_tpu_torch.ops import cuda_build
    lib = cuda_build.load("grouped_gemm")
    if lib.ds_grouped_matmul.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ds_grouped_matmul.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.ds_grouped_matmul.restype = ctypes.c_int
        lib.ds_cuda_error_string.argtypes = [i]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_args(xs, w, group_offsets):
    for name, t in (("w", w), ("group_offsets", group_offsets)):
        if t.device != xs.device:
            raise ValueError(f"{name} is on {t.device}, xs on {xs.device}")
    for name, t in (("xs", xs), ("w", w), ("group_offsets", group_offsets)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xs.dtype not in _DTYPE_CODES:
        raise TypeError(f"xs dtype {xs.dtype} not in {list(_DTYPE_CODES)}")
    if w.dtype != xs.dtype:
        raise TypeError(f"w dtype {w.dtype} != xs dtype {xs.dtype}")
    if xs.dim() != 2 or w.dim() != 3 or w.shape[1] != xs.shape[1]:
        raise ValueError(f"need xs [R, K] and w [E, K, N], got "
                         f"{tuple(xs.shape)}, {tuple(w.shape)}")
    if group_offsets.dtype != torch.int32 or \
            tuple(group_offsets.shape) != (w.shape[0] + 1,):
        raise ValueError(f"group_offsets must be int32 [E+1={w.shape[0] + 1}],"
                         f" got {group_offsets.dtype} "
                         f"{tuple(group_offsets.shape)}")
    reason = unsupported_reason(w.shape[1], w.shape[2])
    if reason:
        raise ValueError(f"grouped_matmul kernel cannot take these shapes: "
                         f"{reason}")
    for name, t in (("xs", xs), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def grouped_matmul(xs, w, group_offsets):
    """``out[r] = xs[r] @ w[e(r)]`` for rows sorted by expert, fp32
    accumulation rounded once to xs's dtype. See the module docstring.

    CUDA tensors launch the sm_90a kernel (``grouped_matmul.launches``
    counts each launch); CPU tensors run ``grouped_matmul_reference``."""
    if xs.device.type == "cpu":
        return grouped_matmul_reference(xs, w, group_offsets)
    if xs.device.type != "cuda":
        raise ValueError(f"grouped_matmul runs on CUDA or CPU tensors, got "
                         f"{xs.device}")
    _check_cuda_args(xs, w, group_offsets)
    R, K = xs.shape
    E, _, N = w.shape
    out = torch.empty(R, N, dtype=xs.dtype, device=xs.device)
    if R == 0:
        return out
    lib = _library()
    rc = lib.ds_grouped_matmul(
        xs.data_ptr(), w.data_ptr(), group_offsets.data_ptr(), out.data_ptr(),
        R, K, N, E, _DTYPE_CODES[xs.dtype],
        torch.cuda.current_stream(xs.device).cuda_stream)
    if rc:
        raise RuntimeError(f"grouped_matmul kernel launch failed: "
                           f"{lib.ds_cuda_error_string(rc).decode()}")
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0


def moe_scatter(top_idx, n_experts):
    """Stable sort of the T*k (token, slot) rows by expert, on the device.
    Returns (order [T*k]: the flat (token, slot) index of each sorted row,
    group_offsets int32 [E+1]). The offsets come from a search of the sorted
    expert ids (``bincount`` would read the largest id on the host)."""
    sorted_e, order = torch.sort(top_idx.reshape(-1), stable=True)
    bounds = torch.arange(n_experts + 1, dtype=sorted_e.dtype,
                          device=sorted_e.device)
    return order, torch.searchsorted(sorted_e, bounds, out_int32=True)


def moe_ffn_gmm(x, top_vals, top_idx, w1, w2, w3, *, n_experts, dtype,
                matmul=grouped_matmul):
    """Mixtral expert FFN ``silu(x@w1) * (x@w3) @ w2`` per expert, routed by
    ``topk_router``'s (top_vals, top_idx): moe_scatter, three grouped
    products (``matmul``: the kernel by default, or its plain version), and
    moe_gather (unsort, gate weighting and the k-slot sum in fp32, cast
    once). x [T, D] -> [T, D] in ``dtype``."""
    T, D = x.shape
    k = top_idx.shape[-1]
    order, offsets = moe_scatter(top_idx, n_experts)
    xs = x[order // k].to(dtype)                              # [T*k, D]
    h = F.silu(matmul(xs, w1, offsets)) * matmul(xs, w3, offsets)
    y = matmul(h, w2, offsets)                                # [T*k, D]
    unsorted = torch.empty_like(y)
    unsorted[order] = y
    return (unsorted.view(T, k, D).float()
            * top_vals[..., None]).sum(1).to(dtype)

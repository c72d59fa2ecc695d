"""Block-sparse self-attention (port of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``, mirroring the
reference ``deepspeed/ops/sparse_attention/sparse_self_attention.py``).

- ``sparse_attention``: masked multi-head attention under a block layout. On
  CUDA tensors it is ``sparse_mha``, the hand-written kernel (a shape the
  kernel cannot take raises; there is no quiet dense fall-back). On CPU
  tensors it is the JAX package's dense masked path, with its rounding
  points: logits in q's dtype, ``finfo.min`` masks, an fp32 softmax cast to
  q's dtype, rows with no enabled key zeroed.
- ``blockwise_sparse_attention``: the O(S x block) memory variant, one
  [block, S] masked softmax per query block (the JAX ``lax.map``).
- ``SparseSelfAttention``: the module, qkv and out projections around
  ``sparse_attention``; ``params_from_flax`` carries the Flax module's
  weights over.
"""

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.ops.block_sparse_attention import sparse_mha


def _token_mask_from_layout(layout, block, device):
    """[H, nb, nb] block layout -> [H, S, S] boolean token mask."""
    layout = torch.as_tensor(np.asarray(layout, bool), device=device)
    return layout.repeat_interleave(block, 1).repeat_interleave(block, 2)


def _scale(q, softmax_scale):
    return softmax_scale if softmax_scale is not None else 1.0 / np.sqrt(q.shape[-1])


def sparse_attention(q, k, v, layout, block, causal=False, softmax_scale=None):
    """Masked multi-head attention under a block-sparsity layout.

    q/k/v: [B, H, S, D]; layout: [H, S/block, S/block] from a
    ``SparsityConfig.make_layout``; returns [B, H, S, D]. CUDA tensors run
    the block-sparse kernel (``sparse_mha``); CPU tensors the JAX package's
    dense masked path ([H, S, S] mask, O(S^2) memory)."""
    if q.device.type == "cuda":
        return sparse_mha(q, k, v, layout, block, causal=causal,
                          softmax_scale=softmax_scale)
    B, H, S, D = q.shape
    mask = _token_mask_from_layout(layout, block, q.device)      # [H, S, S]
    if causal:
        mask = mask & torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    logits = torch.einsum("bhsd,bhtd->bhst", q, k) * _scale(q, softmax_scale)
    logits = torch.where(mask[None], logits, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    # rows with no enabled key get uniform probabilities over finfo.min: zero them
    probs = probs * mask.any(-1)[None, :, :, None]
    return torch.einsum("bhst,bhtd->bhsd", probs, v)


def blockwise_sparse_attention(q, k, v, layout, block, causal=False,
                               softmax_scale=None):
    """O(S x block) memory variant: one query block at a time, so no [S, S]
    attention matrix exists. Each step is one [block, S] masked softmax and
    matmul in the JAX function's dtypes (logits in q's dtype, fp32 softmax
    and PV product, cast to q's dtype)."""
    B, H, S, D = q.shape
    nb = S // block
    scale = _scale(q, softmax_scale)
    layout = torch.as_tensor(np.asarray(layout, bool), device=q.device)
    key_mask = layout.repeat_interleave(block, 2)               # [H, nb, S]
    vf = v.float()
    outs = []
    for i in range(nb):
        qi = q[:, :, i * block:(i + 1) * block]
        logits = torch.einsum("bhqd,bhkd->bhqk", qi, k) * scale
        m = key_mask[:, i][None, :, None, :]                    # [1, H, 1, S]
        if causal:
            rows = i * block + torch.arange(block, device=q.device)
            m = m & (rows[:, None] >= torch.arange(S, device=q.device)[None, :])
        logits = torch.where(m, logits, torch.finfo(logits.dtype).min)
        probs = torch.softmax(logits.float(), dim=-1)
        probs = probs * m.any(-1, keepdim=True)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype))
    return torch.cat(outs, dim=2)


class SparseSelfAttention(nn.Module):
    """QKV projection, block-sparse attention, output projection (the Flax
    module's layout: ``qkv`` Linear(E, 3E) split in thirds, ``out``
    Linear(E, E)). ``forward(x, layout=None)`` builds the layout from the
    sparsity config on every call, as the Flax module does; passing
    ``layout`` shares one layout between runs (BigBird and Variable draw new
    random blocks per ``make_layout``). ``plain=True`` runs the kernel's
    plain version on CUDA tensors, the yardstick a kernel run is compared
    with."""

    def __init__(self, embed_dim, num_heads, sparsity_config, causal=False,
                 dtype=torch.float32, device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.sparsity_config = sparsity_config
        self.causal = causal
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim, dtype=dtype, device=device)
        self.out = nn.Linear(embed_dim, embed_dim, dtype=dtype, device=device)

    def forward(self, x, layout=None, plain=False):
        B, S, E = x.shape
        H = self.num_heads
        D = E // H
        q, k, v = self.qkv(x).split(E, dim=-1)
        q, k, v = (t.reshape(B, S, H, D).transpose(1, 2) for t in (q, k, v))
        if layout is None:
            layout = self.sparsity_config.make_layout(S)
        block = self.sparsity_config.block
        if plain:
            out = sparse_mha(q, k, v, layout, block, causal=self.causal,
                             plain=True)
        else:
            out = sparse_attention(q, k, v, layout, block, causal=self.causal)
        return self.out(out.transpose(1, 2).reshape(B, S, E))


def params_from_flax(params):
    """Flax ``SparseSelfAttention`` params (``{"qkv": {"kernel", "bias"},
    "out": {...}}``, kernels [in, out]) -> the port's state dict (weights
    [out, in])."""
    sd = {}
    for name in ("qkv", "out"):
        sd[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(params[name]["kernel"]).T))
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(params[name]["bias"]).copy())
    return sd

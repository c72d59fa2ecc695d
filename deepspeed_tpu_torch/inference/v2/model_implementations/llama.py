"""Ragged (paged-KV) Llama forward (port of
``deepspeed_tpu/inference/v2/model_implementations/llama.py``).

Runs the weights of ``deepspeed_tpu_torch.models.llama.LlamaForCausalLM``
over a padded ``[S, Q]`` ragged batch: embedding, per layer RMSNorm -> q/k/v
projections -> interleaved rotary -> scatter of the new K/V into the paged
pools -> paged attention -> o projection -> RMSNorm -> SwiGLU MLP, then the
final norm and the logits of each sequence's last real token. Padded token
slots write to the trash block. The JAX package donates its pools to the
jitted forward and gets new ones back; here the pools are updated in place
(``index_put_``), which saves a copy of the whole cache per forward.
``ragged_forward_verify`` (the verify half of speculative decode) runs the
same trunk and returns the logits of each row's last ``k_max`` chunk
positions.

Under tensor parallelism (a model built with ``tp_size`` > 1) the same code
runs on each rank's share of the weights: its query and KV heads (its pools
hold ``KV / tp`` heads, under the global block tables), the vocabulary
slice of the embedding (``vocab_embed``), all-reduces after the row-split o
and down products (``row_linear``, ``row_reduce``), and the ranks' logits
slices gathered (``gather_vocab``), all over ``model.tp``.
"""

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.models.llama import rms_norm, rotary_embed, row_linear
from deepspeed_tpu_torch.ops.paged_attention import paged_mha
from deepspeed_tpu_torch.parallel.tensor_parallel import (gather_vocab, row_reduce,
                                                          vocab_embed)


def _quantize_kv_rows(x):
    """[..., Dh] fp -> (int8 [..., Dh], fp32 scale [...]): symmetric int8
    per row, the JAX package's ``_quantize_rows_ref(rows, 8)`` applied per
    (token, kv head) row."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)
    return q, scale[..., 0]


def _scatter_kv(k_pool, v_pool, k_scale, v_scale, k, v, block_tables, seen,
                q_len):
    """Write [S, Q, KV, Dh] new KVs into one layer's [NB+1, KV, bs, Dh]
    pools, in place, through the block tables. Padded token slots go to the
    trash block (the pools' last block); a block index past the table clamps,
    as the JAX gather's ``mode="clip"`` does. int8 pools quantize on write
    per (token, kv head) row and scatter the fp32 scale into the side pools
    [NB+1, KV, 1, bs] under the same block/slot indices."""
    S, Q = k.shape[:2]
    nb, _, bs, _ = k_pool.shape          # includes the trash block
    tok = torch.arange(Q, device=k.device)
    pos = seen.long()[:, None] + tok[None, :]                     # [S, Q]
    valid = tok[None, :] < q_len.long()[:, None]
    blk = torch.gather(block_tables.long(), 1,
                       (pos // bs).clamp(max=block_tables.shape[1] - 1))
    bi = torch.where(valid, blk, nb - 1).reshape(-1)              # [S*Q]
    si = torch.where(valid, pos % bs, 0).reshape(-1)
    if k_scale is not None:
        k, ks = _quantize_kv_rows(k)     # int8 [S,Q,KV,Dh], f32 [S,Q,KV]
        v, vs = _quantize_kv_rows(v)
        # advanced indices at dims (0, 2) of the [NB+1, KV, bs] view
        # straddle the head slice, so values land as [S*Q, KV]
        k_scale[:, :, 0][bi, :, si] = ks.reshape(S * Q, -1)
        v_scale[:, :, 0][bi, :, si] = vs.reshape(S * Q, -1)
    k_pool[bi, :, si] = k.reshape(S * Q, *k.shape[2:]).to(k_pool.dtype)
    v_pool[bi, :, si] = v.reshape(S * Q, *v.shape[2:]).to(v_pool.dtype)


def attention_block(layer, x, i, kv_cache, positions, block_tables, seen, q_len,
                    attention, tp):
    """``x`` plus one layer's attention over the paged pools, on this rank's
    heads: RMSNorm, q/k/v, rotary, the scatter of the new K/V into layer
    ``i``'s pools, paged attention, and the row-split o product reduced
    over ``tp``."""
    cfg, attn = layer.self_attn.config, layer.self_attn
    S, Q = x.shape[:2]
    H, KV, Dh = attn.num_heads, attn.num_kv_heads, cfg.head_dim
    h = rms_norm(x, layer.input_layernorm.weight, cfg.rms_norm_eps)
    q = F.linear(h, attn.q_proj.weight, attn.q_proj.bias).view(S, Q, H, Dh)
    k = F.linear(h, attn.k_proj.weight, attn.k_proj.bias).view(S, Q, KV, Dh)
    v = F.linear(h, attn.v_proj.weight, attn.v_proj.bias).view(S, Q, KV, Dh)
    q = rotary_embed(q, positions, cfg.rope_theta)
    k = rotary_embed(k, positions, cfg.rope_theta)
    kp, vp, ks, vs = kv_cache.layer(i)
    _scatter_kv(kp, vp, ks, vs, k, v, block_tables, seen, q_len)
    out = attention(q, kp, vp, block_tables, seen, q_len, k_scale=ks,
                    v_scale=vs, window=cfg.sliding_window)
    return x + row_linear(out.reshape(S, Q, H * Dh), attn.o_proj, tp)


def _ragged_trunk(model, kv_cache, tokens, q_len, seen, block_tables,
                  attention):
    """The embedding -> layers -> final-norm trunk shared by
    ``ragged_forward`` and ``ragged_forward_verify``, so that a verify round
    runs the same paged-attention call as a plain round. Returns the normed
    hidden states [S, Q, D]; updates the pools in place."""
    cfg, tp = model.config, model.tp
    Q = tokens.shape[1]
    positions = seen.long()[:, None] + torch.arange(Q, device=tokens.device)

    x = vocab_embed(model.embed_tokens.weight, tokens.long(), tp)   # [S, Q, D]
    for i, layer in enumerate(model.layers):
        x = attention_block(layer, x, i, kv_cache, positions, block_tables, seen,
                            q_len, attention, tp)
        mlp = layer.mlp
        h = rms_norm(x, layer.post_attention_layernorm.weight, cfg.rms_norm_eps)
        gate = F.silu(F.linear(h, mlp.gate_proj.weight))
        x = x + row_reduce(F.linear(gate * F.linear(h, mlp.up_proj.weight),
                                    mlp.down_proj.weight), tp)
    return rms_norm(x, model.norm.weight, cfg.rms_norm_eps)


@torch.no_grad()
def ragged_forward(model, kv_cache, tokens, q_len, seen, block_tables,
                   attention=paged_mha):
    """One ragged forward step over ``model`` (a ``LlamaForCausalLM``).

    ``tokens`` [S, Q], ``q_len``/``seen`` [S] and ``block_tables`` [S, MB]
    are int32 tensors on the model's device; ``kv_cache`` is the engine's
    ``BlockedKVCache``, whose pools this call updates in place.
    ``attention`` has ``paged_mha``'s signature: the kernel by default, or
    its plain version. Returns last-token logits [S, V] in fp32."""
    x = _ragged_trunk(model, kv_cache, tokens, q_len, seen, block_tables,
                      attention)
    S = tokens.shape[0]
    # logits_gather analog: only the last real token of each sequence
    last = x[torch.arange(S, device=x.device), (q_len.long() - 1).clamp(min=0)]
    return gather_vocab(F.linear(last, model.lm_head.weight), model.tp).float()


@torch.no_grad()
def ragged_forward_verify(model, kv_cache, tokens, q_len, seen, block_tables,
                          k_max, attention=paged_mha):
    """One ragged forward returning the logits of each row's last ``k_max``
    chunk positions: the verify half of draft-then-verify decode. The trunk
    is ``ragged_forward``'s, so a verify round runs the same paged-attention
    kernel as plain prefill; only the logits gather widens.

    Columns are last-aligned: for row ``s`` with chunk length ``q_len[s]``,
    column ``c`` holds the logits after chunk position
    ``q_len[s] - k_max + c`` (clamped into the chunk), so column
    ``k_max - 1`` is the row's ordinary last-token logits. Each column's
    ``lm_head`` product runs at the plain forward's ``[S, D] @ [D, V]``
    shape, never as one ``[S * k_max, D]`` product: the library picks its
    algorithm by shape, and the last column must equal ``ragged_forward``'s
    logits bit for bit. Returns [S, k_max, V] fp32."""
    x = _ragged_trunk(model, kv_cache, tokens, q_len, seen, block_tables,
                      attention)
    S = tokens.shape[0]
    rows = torch.arange(S, device=x.device)
    ql = q_len.long()
    cap = (ql - 1).clamp(min=0)
    cols = []
    for c in range(int(k_max)):
        idx = torch.minimum((ql - k_max + c).clamp(min=0), cap)
        cols.append(gather_vocab(F.linear(x[rows, idx], model.lm_head.weight),
                                 model.tp).float())
    return torch.stack(cols, dim=1)

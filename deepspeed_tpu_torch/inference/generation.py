"""Autoregressive generation over a KV-cached model (port of
``deepspeed_tpu/inference/generation.py``).

A prefill runs the whole [B, Tp] prompt through the model's fixed-window
cache, then a Python loop feeds one token per row per step, until
``max_new_tokens`` or until every row has produced ``eos_token_id``
(checked on the host only when an EOS id is given). Prompts in a batch share
one length; mixed lengths are the ragged v2 engine's job.

Model contract: ``model(ids, positions=pos, use_cache=True, cache=cache)
-> (logits, cache)``, the cache made by :func:`init_cache` (a
``models/llama.py`` ``KVCache``): the Llama families and the parallel-block
families (Falcon, Phi) keep it. Sampling draws from a
``torch.Generator``; JAX's threefry stream cannot be matched, so sampled
tokens differ from the JAX package's while greedy tokens are equal. Under
tensor parallelism (``tp``) every rank holds the same gathered logits; a
sampled token is drawn on tp rank 0 alone and broadcast, so the ranks feed
the same tokens.
"""

import torch

from deepspeed_tpu_torch.models.llama import KVCache
from deepspeed_tpu_torch.parallel.tensor_parallel import (TensorParallel,
                                                          broadcast_from_controller)


def sample_logits(logits, generator=None, temperature=1.0, top_k=0, top_p=1.0):
    """Next token from [B, V] logits: greedy (the first maximum) when
    ``temperature == 0``; else top-k and top-p filtered with ``-1e9`` and
    drawn from ``softmax(logits / temperature)`` by ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, -1e9, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # smallest set with cumulative probability >= top_p; the top token stays
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, -1e9, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def init_cache(model, input_ids):
    """A zeroed cache for ``model`` and a batch shaped like ``input_ids``,
    in the dtype its activations take (the embedding's)."""
    weight = model.embed_tokens.weight
    layer = model.layers[0]
    return KVCache(model.config, input_ids.shape[0], weight.dtype, weight.device,
                   num_kv_heads=getattr(layer, "self_attn", layer).num_kv_heads)


def _next_token(logits, generator, temperature, top_k, top_p, tp):
    """``sample_logits``; a sampled token under ``tp`` is tp rank 0's."""
    if tp.size == 1 or temperature == 0.0:
        return sample_logits(logits, generator, temperature, top_k, top_p)
    if tp.rank == 0:
        tok = sample_logits(logits, generator, temperature, top_k, top_p)
    else:
        tok = torch.empty(logits.shape[0], dtype=torch.long, device=logits.device)
    return broadcast_from_controller(tok, tp)


@torch.no_grad()
def generate(model, input_ids, max_new_tokens=32, temperature=0.0, top_k=0, top_p=1.0,
             generator=None, eos_token_id=None, tp=TensorParallel()):
    """``max_new_tokens`` continuation tokens for [B, Tp] prompts
    (``temperature`` 0.0 = greedy), as an int64 [B, max_new_tokens] tensor
    on the model's device. Rows that finished are padded with EOS. ``tp``:
    the tensor-parallel group whose rank 0 draws sampled tokens."""
    device = model.embed_tokens.weight.device
    input_ids = torch.as_tensor(input_ids).to(device=device, dtype=torch.long)
    B, Tp = input_ids.shape
    max_pos = model.config.max_position_embeddings
    if Tp + max_new_tokens > max_pos:
        raise ValueError(
            f"prompt ({Tp}) + max_new_tokens ({max_new_tokens}) exceeds the model's "
            f"KV-cache window (max_position_embeddings={max_pos})")
    cache = init_cache(model, input_ids)
    positions = torch.arange(Tp, device=device)[None, :].expand(B, Tp)
    logits, cache = model(input_ids, positions=positions, use_cache=True, cache=cache)
    out = torch.zeros(B, max_new_tokens, dtype=torch.long, device=device)
    out[:, 0] = _next_token(logits[:, -1], generator, temperature, top_k, top_p, tp)
    finished = out[:, 0] == eos_token_id if eos_token_id is not None else None
    for i in range(1, max_new_tokens):
        if finished is not None and bool(finished.all()):
            break
        pos = torch.full((B, 1), Tp - 1 + i, dtype=torch.long, device=device)
        logits, cache = model(out[:, i - 1:i], positions=pos, use_cache=True, cache=cache)
        nxt = _next_token(logits[:, -1], generator, temperature, top_k, top_p, tp)
        if finished is not None:
            nxt = torch.where(finished, eos_token_id, nxt)
            finished = finished | (nxt == eos_token_id)
        out[:, i] = nxt
    if eos_token_id is not None:
        # the loop stops once every row has finished; pad the tail
        is_eos = (out == eos_token_id).long()
        seen_before = (torch.cumsum(is_eos, dim=1) - is_eos) > 0
        out = torch.where(seen_before, eos_token_id, out)
    return out

"""On-device per-sequence sampling for the ragged serving path (port of
``deepspeed_tpu/inference/v2/sampling.py``).

Temperature, top-k and top-p are applied to the ``[S, V]`` logits on the
device; the host receives only ``[S]`` int32 token ids. Semantics mirror the
JAX package: greedy (argmax) at temperature 0; top-k keeps values >= the kth
largest; top-p keeps the smallest set with cumulative probability >= top_p,
always including the top token, computed over the top-k-masked distribution.

Determinism: each sampled row draws its Gumbel noise from a
``torch.Generator`` seeded from ``(seed, position)`` alone, so a
(seed, position) pair always gives the same token whatever the batch. The
JAX package draws with threefry; torch cannot reproduce those bits, so
sampled streams match within the port, not across packages.

``verify_rows`` (speculative decode) samples every column of a verify
round's ``[S, K, V]`` logits at the stream position that column stands for,
so an accepted draft is exactly the token plain decode draws there.
"""

import torch

_NEG = -1e9


def stream_seed(seed: int, position: int) -> int:
    """The generator seed of stream ``seed`` at ``position`` (distinct for
    every pair of a 31-bit seed and a 32-bit position)."""
    return ((int(seed) & 0x7FFFFFFF) << 32) | (int(position) & 0xFFFFFFFF)


def _mask_rows(logits, temps, top_ks, top_ps):
    """Temperature-scaled logits [R, V] with top-k / top-p exclusions set to
    ``_NEG`` (per-row parameters as [R] tensors)."""
    v = logits.shape[-1]
    scaled = logits.float() / temps.clamp_min(1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = sorted_desc.gather(1, (top_ks - 1).clamp(0, v - 1)[:, None])
    use_k = (top_ks > 0)[:, None]
    masked = torch.where(use_k & (scaled < kth), _NEG, scaled)
    # below-kth values masked to _NEG keep descending order, so the sorted
    # masked row falls out of the first sort
    sorted_m = torch.where(use_k & (sorted_desc < kth), _NEG, sorted_desc)
    probs = torch.softmax(sorted_m, dim=-1)
    cutoff_idx = (torch.cumsum(probs, dim=-1) < top_ps[:, None]).sum(-1)
    cutoff = sorted_m.gather(1, cutoff_idx.clamp(0, v - 1)[:, None])
    return torch.where((top_ps < 1.0)[:, None] & (masked < cutoff), _NEG,
                       masked)


def sample_rows(logits, temperatures, top_ks, top_ps, seeds, positions):
    """Per-row sampling of ``logits`` [S, V] (a device tensor straight from
    the forward). The parameter lists cover the first ``n <= S`` rows; rows
    past them are padding and come back greedy. Returns [S] int32 ids on the
    logits' device — no host sync."""
    ids = torch.argmax(logits, dim=-1).to(torch.int32)
    rows = [i for i, t in enumerate(temperatures) if t > 0.0]
    if not rows:
        return ids
    dev = logits.device

    def pick(vals, dtype):
        return torch.tensor([vals[i] for i in rows], dtype=dtype, device=dev)

    masked = _mask_rows(logits[rows], pick(temperatures, torch.float32),
                        pick(top_ks, torch.long), pick(top_ps, torch.float32))
    noise = torch.empty_like(masked)
    for j, i in enumerate(rows):
        gen = torch.Generator(device=dev)
        gen.manual_seed(stream_seed(seeds[i], positions[i]))
        noise[j].exponential_(generator=gen)
    # Gumbel-max: -log(Exp(1)) is standard Gumbel noise
    draws = torch.argmax(masked - torch.log(noise), dim=-1)
    ids[rows] = draws.to(torch.int32)
    return ids


def verify_rows(logits, temperatures, top_ks, top_ps, seeds, positions):
    """Per-row, per-column sampling of a draft-then-verify round: the port's
    counterpart of the JAX package's ``verify_rows_packed``.

    ``logits`` is [S, K, V], each row's last ``K`` chunk positions
    (last-aligned, from ``ragged_forward_verify``). ``positions[s]`` is row
    ``s``'s stream position for the final column; column ``c`` draws at
    ``positions[s] - (K - 1) + c`` with the row's own temperature, top-k,
    top-p and seed: exactly the draw ``sample_rows`` makes once the stream
    reaches that position. The parameter lists cover the first ``n <= S``
    rows; padding rows and greedy rows take the argmax. Returns [S, K]
    int32 ids on the logits' device — no host sync."""
    S, K, V = logits.shape
    ids = torch.argmax(logits, dim=-1).to(torch.int32)
    rows = [i for i, t in enumerate(temperatures) if t > 0.0]
    if not rows:
        return ids
    flat = [(i, c) for i in rows for c in range(K)]
    cols = [positions[i] - (K - 1) + c for i, c in flat]
    drawn = sample_rows(logits[[i for i, _ in flat], [c for _, c in flat]],
                        [temperatures[i] for i, _ in flat],
                        [top_ks[i] for i, _ in flat],
                        [top_ps[i] for i, _ in flat],
                        [seeds[i] for i, _ in flat], cols)
    ids[rows] = drawn.view(len(rows), K)
    return ids

"""Self-speculation drafters for draft-then-verify decode (port of
``deepspeed_tpu/inference/v2/speculative.py``).

A drafter proposes up to ``k`` candidate continuation tokens for a sequence;
the scheduler verifies them in one forward through the same ragged forward
plain prefill uses (a verify round is a SplitFuse chunk). Drafters are pure
host-side token-id lookups: a wrong draft costs only the rejected tail of
the verify chunk (rolled back off the paged cursor), never correctness —
accepted tokens are by construction the tokens plain decode would have
emitted at the same ``(seed, position)`` stream points.

``NgramDrafter`` is prompt-lookup self-speculation (no extra weights):
match the longest suffix n-gram of ``prompt + generated`` against an earlier
occurrence in the same context and propose the tokens that followed it.
"""


class NgramDrafter:
    """Longest-suffix n-gram prompt-lookup drafter with chained lookup.

    ``draft(context, k)`` scans for the most recent earlier occurrence of
    the longest matching suffix n-gram (length ``ngram_max`` down to 1) and
    proposes the tokens that followed it. When the matched occurrence sits
    near the context tail its follow window is short — the common case on a
    cyclic tail, where the most recent match is exactly one period back —
    so the drafted tokens are appended to the lookup context and matching
    repeats until ``k`` tokens are drafted or nothing matches. Returns
    ``[]`` when nothing matches at all: the round degrades to plain decode
    for that row.
    """

    def __init__(self, ngram_max=3):
        if ngram_max < 1:
            raise ValueError(f"ngram_max must be >= 1, got {ngram_max}")
        self.ngram_max = int(ngram_max)

    def _lookup(self, context, k):
        n_ctx = len(context)
        for n in range(min(self.ngram_max, n_ctx - 1), 0, -1):
            suffix = tuple(context[n_ctx - n:])
            # most recent earlier occurrence wins
            for start in range(n_ctx - n - 1, -1, -1):
                if tuple(context[start:start + n]) == suffix:
                    follow = context[start + n:start + n + k]
                    if follow:
                        return [int(t) for t in follow]
        return []

    def draft(self, context, k):
        if k <= 0 or len(context) < 2:
            return []
        out = []
        ctx = list(context)
        while len(out) < k:
            got = self._lookup(ctx, k - len(out))
            if not got:
                break
            out.extend(got)
            ctx.extend(got)
        return out

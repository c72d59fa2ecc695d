"""Ragged batch assembly (port of
``deepspeed_tpu/inference/v2/ragged/ragged_wrapper.py``).

A *padded dense* batch: ``[S, Q]`` token ids (S = sequence slots, Q =
per-seq new-token budget) plus per-sequence metadata (true new-token counts,
tokens already in cache, block tables). Padding rows/cols are masked inside
the model and their KV writes go to the trash block. The power-of-two
``[S, Q]`` bucketing is kept from the reference for parity; its GEMM cost on
mixed batches is logged as later perf work in ROADMAP.md.
"""

import numpy as np


class RaggedBatchWrapper:

    def __init__(self, max_seqs, max_new_tokens_per_seq, max_blocks_per_seq,
                 trash_block):
        self.max_seqs = max_seqs
        self.max_q = max_new_tokens_per_seq
        self.max_blocks = max_blocks_per_seq
        self.trash_block = trash_block
        self.clear()

    def clear(self):
        self._rows = []  # (uid, tokens, seen, blocks)

    def insert_sequence(self, uid, tokens, seen_tokens, kv_blocks):
        if len(self._rows) >= self.max_seqs:
            raise ValueError(f"batch already holds {self.max_seqs} sequences")
        if len(tokens) > self.max_q:
            raise ValueError(f"{len(tokens)} new tokens > per-seq budget {self.max_q}")
        if len(kv_blocks) > self.max_blocks:
            raise ValueError(f"sequence needs {len(kv_blocks)} blocks > table width "
                             f"{self.max_blocks}")
        self._rows.append((uid, list(tokens), seen_tokens, list(kv_blocks)))

    @property
    def current_sequences(self):
        return len(self._rows)

    @property
    def current_tokens(self):
        return sum(len(t) for _, t, _, _ in self._rows)

    @property
    def uids(self):
        return [u for u, _, _, _ in self._rows]

    def build(self):
        """Pad to the static [S, Q] / [S, MB] layout.

        S and Q are bucketed to the smallest power of two covering the batch
        (min 4 sequences / 8 tokens), as in the reference.
        """
        S = 4
        while S < len(self._rows):
            S *= 2
        S = min(S, self.max_seqs)
        longest = max((len(t) for _, t, _, _ in self._rows), default=1)
        Q = 8
        while Q < longest:
            Q *= 2
        Q = min(Q, self.max_q)

        tokens = np.zeros((S, Q), np.int32)
        q_len = np.zeros((S,), np.int32)
        seen = np.zeros((S,), np.int32)
        block_tables = np.full((S, self.max_blocks), self.trash_block, np.int32)
        for i, (_, toks, sn, blocks) in enumerate(self._rows):
            tokens[i, :len(toks)] = toks
            q_len[i] = len(toks)
            seen[i] = sn
            block_tables[i, :len(blocks)] = blocks
        return {"tokens": tokens, "q_len": q_len, "seen": seen,
                "block_tables": block_tables}

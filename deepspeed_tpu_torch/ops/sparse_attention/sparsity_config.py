"""Block-sparsity layout configs (port of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``, itself mirroring
the reference ``deepspeed/ops/sparse_attention/sparsity_config.py``, 727L):
each config builds a per-head block layout — an int [heads, num_blocks,
num_blocks] 0/1 array marking which key blocks each query block attends to.

Pure numpy index logic, kept as the port's own copy so that layouts are
identical to the JAX package's element for element. BigBird and Variable draw
their random blocks from ``np.random.default_rng(seed)``, which advances on
every ``make_layout`` call: two sides that must agree either share one
layout or build their configs fresh from the same seed.
"""

import numpy as np


class SparsityConfig:
    """Base (reference :24): ``block`` is the square block size; layouts are
    np.int32 [num_heads, seq/block, seq/block]."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len):
        if seq_len % self.block != 0:
            raise ValueError(
                f"sequence length {seq_len} must be divisible by block {self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), dtype=np.int64)

    def check_and_propagate_first_head_layout(self, layout):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len):
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """reference :88 — all blocks attend everywhere (testing/fallback)."""

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """reference :114 — local windows + fixed global blocks. Each query block
    attends to its window of ``num_local_blocks`` and to
    ``num_global_blocks`` representative blocks of every *preceding* window
    (unidirectional) or all windows (bidirectional)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional", horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(f"attention {attention}")
        self.attention = attention
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires bidirectional")
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def _local(self, layout, h):
        nb = layout.shape[1]
        for start in range(0, nb, self.num_local_blocks):
            end = min(start + self.num_local_blocks, nb)
            for i in range(start, end):
                hi = end if self.attention == "bidirectional" else i + 1
                layout[h, i, start:hi] = 1
        return layout

    def _global(self, layout, h):
        nb = layout.shape[1]
        # representative (last) blocks of each window serve as global keys;
        # head (or pattern index) rotates which block is representative
        pattern = h % self.num_different_global_patterns \
            if self.different_layout_per_head else 0
        first_global = self.num_local_blocks - (1 + pattern) \
            if self.num_local_blocks >= self.num_global_blocks else 0
        for start in range(0, nb, self.num_local_blocks):
            gstart = start + first_global
            gend = min(gstart + self.num_global_blocks, nb)
            if self.attention == "unidirectional":
                # all FOLLOWING query blocks attend back to these globals
                layout[h, start + self.num_local_blocks:, gstart:gend] = 1
            else:
                layout[h, :, gstart:gend] = 1
            if self.horizontal_global_attention:
                layout[h, gstart:gend, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self._local(layout, h)
            self._global(layout, h)
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class VariableSparsityConfig(SparsityConfig):
    """reference :283 — custom local window list + explicit global indices."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=None,
                 global_block_indices=None, global_block_end_indices=None,
                 attention="bidirectional", horizontal_global_attention=False,
                 seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self._rng = np.random.default_rng(seed)

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        for h in range(self.num_layout_heads):
            # local: consecutive windows of the listed sizes (last repeats)
            start = 0
            wi = 0
            while start < nb:
                w = self.local_window_blocks[min(wi, len(self.local_window_blocks) - 1)]
                end = min(start + w, nb)
                for i in range(start, end):
                    hi = end if self.attention == "bidirectional" else i + 1
                    layout[h, i, start:hi] = 1
                start = end
                wi += 1
            # random
            for i in range(nb):
                if self.num_random_blocks:
                    cols = self._rng.choice(nb, self.num_random_blocks, replace=False)
                    layout[h, i, cols] = 1
            # global
            if self.global_block_end_indices:
                spans = zip(self.global_block_indices, self.global_block_end_indices)
            else:
                spans = ((g, g + 1) for g in self.global_block_indices)
            for g0, g1 in spans:
                g1 = min(g1, nb)
                if g0 >= nb:
                    continue
                layout[h, :, g0:g1] = 1
                if self.horizontal_global_attention:
                    layout[h, g0:g1, :] = 1
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class BigBirdSparsityConfig(SparsityConfig):
    """reference :425 — random + sliding window + global blocks."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, attention="bidirectional", seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self._rng = np.random.default_rng(seed)

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for i in range(nb):
                lo, hi = max(0, i - w), min(nb, i + w + 1)
                layout[h, i, lo:hi] = 1
                if self.num_random_blocks:
                    pool = nb if self.attention == "bidirectional" else max(1, i + 1)
                    cols = self._rng.choice(pool, min(self.num_random_blocks, pool),
                                            replace=False)
                    layout[h, i, cols] = 1
            g = min(self.num_global_blocks, nb)
            layout[h, :, :g] = 1   # everyone sees global keys
            layout[h, :g, :] = 1   # global queries see everyone
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class BSLongformerSparsityConfig(SparsityConfig):
    """reference :573 — sliding window + designated global block indices."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=None,
                 global_block_end_indices=None, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for i in range(nb):
                layout[h, i, max(0, i - w):min(nb, i + w + 1)] = 1
            if self.global_block_end_indices:
                spans = zip(self.global_block_indices, self.global_block_end_indices)
            else:
                spans = ((g, g + 1) for g in self.global_block_indices)
            for g0, g1 in spans:
                g1 = min(g1, nb)
                if g0 >= nb:
                    continue
                layout[h, :, g0:g1] = 1
                layout[h, g0:g1, :] = 1
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """reference :685 — pure sliding window."""

    def __init__(self, num_heads, block=16, num_sliding_window_blocks=3,
                 attention="unidirectional"):
        super().__init__(num_heads, block, different_layout_per_head=False)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for i in range(nb):
                lo = max(0, i - w)
                hi = min(nb, i + w + 1) if self.attention == "bidirectional" else i + 1
                layout[h, i, lo:hi] = 1
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout

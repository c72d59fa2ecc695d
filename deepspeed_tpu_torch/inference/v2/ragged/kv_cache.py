"""Blocked (paged) KV cache (port of
``deepspeed_tpu/inference/v2/ragged/kv_cache.py``).

Device layout: one K pool and one V pool, torch tensors shaped
``[num_layers, num_blocks + 1, num_kv_heads, block_size, head_dim]`` on the
engine's device — (block_size, head_dim) minor, so one page of one kv head is
a contiguous ``block_size * head_dim`` run the paged-attention kernel stages
whole. Block ids are handed out by the host-side ``BlockedAllocator``; the
model's forward scatters new KVs into the pools in place and attends through
block tables. One extra *trash block* (index ``num_blocks``) absorbs writes
from padded token slots.

``kv_dtype="int8"`` stores the pools int8 with per-token fp32 scales in side
pools shaped ``[num_layers, num_blocks + 1, num_kv_heads, 1, block_size]``
(one scale per token row over head_dim): quantization happens on write in the
forward, dequantization inside the paged-attention kernel.

Storage tiers below the device pool:

* preemption swaps a live sequence's pages to CPU tensors and back with
  plain synchronous copies (``swap_out`` / ``swap_in``);
* the host-DRAM spill tier (``host_capacity`` blocks) behind the allocator's
  fourth block state: parked prefix blocks spill device->host through a
  double-buffered ``HostKVSwapper`` (pinned host memory, a copy stream)
  instead of being evicted, and restore on prefix hits. Every landing goes
  through the injectable accounted fetch (``set_host_fetch``). With
  telemetry on, landings and restores are timed into
  ``serving/kv_swap_out_s`` and ``serving/kv_swap_in_s``.

Page transfer for the serving fleet: ``export_blocks`` gathers (copies)
block rows for shipping to another pool and ``import_blocks`` binds shipped
rows under fresh ids. Throughout, a "page array" is a tensor (fp pools) or
an ``(int8 data, fp32 scale)`` pair (int8 pools).

The JAX package's NVMe rung under the host tier waits for ROADMAP A14.
"""

import time

import torch

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.runtime.swap_tensor.kv_swapper import HostKVSwapper

# module-level clock alias, so tests can prove that the disabled telemetry
# path never reads it
_now = time.perf_counter

_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16,
           "fp32": torch.float32}


def split_pages(x):
    """Page array -> (data, scale_or_None); accepts both conventions."""
    return x if isinstance(x, tuple) else (x, None)


class BlockedKVCache:

    def __init__(self, num_layers, num_blocks, block_size, num_kv_heads,
                 head_dim, dtype="bf16", kv_dtype="fp", *, device,
                 host_capacity=0):
        if kv_dtype not in ("fp", "int8"):
            raise ValueError(f"kv_dtype must be 'fp' or 'int8', got {kv_dtype!r}")
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.quantized = (kv_dtype == "int8")
        self.device = torch.device(device)
        self.dtype = torch.int8 if self.quantized else _DTYPES.get(dtype, dtype)
        # +1 trash block for masked writes
        shape = (num_layers, num_blocks + 1, num_kv_heads, block_size, head_dim)
        self.k_pool = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=self.dtype, device=self.device)
        if self.quantized:
            sshape = (num_layers, num_blocks + 1, num_kv_heads, 1, block_size)
            self.k_scale = torch.ones(sshape, dtype=torch.float32,
                                      device=self.device)
            self.v_scale = torch.ones(sshape, dtype=torch.float32,
                                      device=self.device)
        else:
            self.k_scale = self.v_scale = None
        self._allocator = BlockedAllocator(num_blocks,
                                           host_capacity=host_capacity)
        self._fetch = None  # injectable accounted device->host fetch
        self._swapper = HostKVSwapper(self._fetch_arrays, buffer_count=2,
                                      land_wrapper=self._timed_land)

    @property
    def allocator(self) -> BlockedAllocator:
        """Host-side block allocator (refcounts, prefix-cache binding)."""
        return self._allocator

    @property
    def free_blocks(self) -> int:
        return self._allocator.free_blocks

    @property
    def occupancy(self) -> float:
        """Fraction of pool blocks currently allocated (host-side read)."""
        return 1.0 - self._allocator.free_blocks / self.num_blocks

    def allocator_stats(self):
        """Free-list depth + fragmentation (``BlockedAllocator.stats``)."""
        return self._allocator.stats()

    @property
    def trash_block(self) -> int:
        return self.num_blocks

    def reserve(self, num_blocks):
        """Allocate block ids (reference ``kv_cache.py:144``)."""
        return self._allocator.allocate(num_blocks)

    def free(self, blocks):
        """Return block ids to the pool (reference ``kv_cache.py:155``)."""
        self._allocator.free(blocks)

    def layer(self, i):
        """Layer ``i``'s pools as ``(k, v, k_scale, v_scale)`` views; the
        scales are None for fp pools. Writes through the views land in the
        pools (the forward updates them in place)."""
        if self.quantized:
            return (self.k_pool[i], self.v_pool[i], self.k_scale[i],
                    self.v_scale[i])
        return self.k_pool[i], self.v_pool[i], None, None

    # -- accounted device->host transfers ----------------------------------
    def set_host_fetch(self, fetch):
        """Route every device->host landing (swap_out, spill) through
        ``fetch(value, what) -> cpu tensor`` — the engine wires its accounted
        ``host_fetch`` in so ``host_sync_count`` sees KV swap traffic."""
        self._fetch = fetch

    def _fetch_arrays(self, arrays, what):
        """Land a tuple of tensors on the host through the accounted fetch."""
        if self._fetch is not None:
            return tuple(self._fetch(a, what) for a in arrays)
        return tuple(a.to("cpu") for a in arrays)

    def _timed_land(self, thunk):
        """Spill landing hook: times the landing into
        ``serving/kv_swap_out_s`` only when telemetry is on (the disabled
        path never reads the clock)."""
        tm = telemetry.get_telemetry()
        if not tm.enabled:
            return thunk()
        t0 = _now()
        out = thunk()
        tm.record_hist("serving/kv_swap_out_s", _now() - t0)
        return out

    def _pools(self):
        pools = [self.k_pool, self.v_pool]
        if self.quantized:
            pools += [self.k_scale, self.v_scale]
        return pools

    # -- host swap tier (ZeRO-Inference KV offload analog) -----------------
    def read_pages(self, blocks):
        """The given block rows of every pool (scales included), landed on
        the host."""
        idx = torch.tensor(list(blocks), dtype=torch.long, device=self.device)
        return self._fetch_arrays([p.index_select(1, idx) for p in self._pools()],
                                  "kv_cache/swap_out")

    def write_pages(self, blocks, parts):
        """Write ``read_pages``' ``parts`` into block rows ``blocks``, in
        order."""
        idx = torch.tensor(list(blocks), dtype=torch.long, device=self.device)
        for pool, part in zip(self._pools(), parts):
            pool.index_copy_(1, idx, part.to(self.device))

    def swap_out(self, blocks):
        """Copy the given block rows to CPU tensors and release the caller's
        reference on their ids. Returns an opaque host handle for
        ``swap_in``."""
        blocks = list(blocks)
        landed = self.read_pages(blocks)
        self._allocator.free(blocks)
        return {"n": len(blocks), "parts": landed}

    def swap_in(self, handle):
        """Restore swapped blocks into freshly allocated ids (order preserved:
        the i-th restored block holds what the i-th swapped-out block held).
        Returns the new block ids."""
        new_blocks = self._allocator.allocate(handle["n"])
        self.write_pages(new_blocks, handle["parts"])
        return new_blocks

    # -- host-DRAM spill tier (parked prefix blocks) -----------------------
    # Unlike ``swap_out`` (live-sequence preemption: synchronous handle, ids
    # freed), spills keep the block's identity alive in the allocator's
    # fourth state: the gather runs on the compute stream here, its copy to
    # pinned host memory on the swapper's copy stream, and it lands when the
    # double-buffered swapper rotates (or a restore demands it), so decode
    # steps launched in between overlap the copies.
    def _gather_pages(self, idx):
        """Gathered copies of the given block rows (and their scales)."""
        return tuple(p.index_select(1, idx) for p in self._pools())

    def spill_block(self, block):
        """Start a parked block's pages on their way to the host; returns
        the opaque payload for ``BlockedAllocator.spill`` (pending until
        landed)."""
        idx = torch.tensor([block], dtype=torch.long, device=self.device)
        return self._swapper.submit(self._gather_pages(idx))

    def restore_block(self, payload, block):
        """Scatter a spilled payload's pages into device block ``block``
        (freshly allocated by the caller): exactly the bytes that were
        spilled, scale pools included. Lands the payload first if its copy
        is still in flight."""
        parts = self._swapper.land(payload)
        tm = telemetry.get_telemetry()
        t0 = _now() if tm.enabled else 0.0
        idx = torch.tensor([block], dtype=torch.long, device=self.device)
        for pool, part in zip(self._pools(), parts):
            pool.index_copy_(1, idx, part.to(self.device, non_blocking=True))
        if tm.enabled:
            tm.record_hist("serving/kv_swap_in_s", _now() - t0)

    @property
    def swapper(self) -> HostKVSwapper:
        return self._swapper

    # -- page transfer (prefill/decode disaggregation) ---------------------
    # Unlike the swap tier above, these never land on the host: the gather
    # stays on this pool's device, so ``KVPageTransport`` can move it to the
    # destination's device (a peer copy across cards, nothing on one card)
    # or through the wire codec. The JAX package pads a transfer to a power
    # of two (``_pad_pages``) so its gather/scatter pair compiles once per
    # bucket; eager PyTorch has no compile to share, so the port ships
    # exactly the rows asked for.
    def export_blocks(self, blocks):
        """Gather the given block rows for shipping to another pool. The
        gather COPIES, so the caller may free or donate the source ids at
        once: a later eviction of a donated block cannot corrupt the shipped
        pages. Returns ``(k, v)`` shaped ``[num_layers, len(blocks), heads,
        block_size, head_dim]``, each a ``(data, scale)`` pair when the
        pool is int8."""
        idx = torch.tensor(list(blocks), dtype=torch.long, device=self.device)
        parts = self._gather_pages(idx)
        if self.quantized:
            return (parts[0], parts[2]), (parts[1], parts[3])
        return parts[0], parts[1]

    def import_blocks(self, k, v, n):
        """Bind the first ``n`` shipped block rows into this pool under
        freshly allocated ids (refcount 1 through the allocator, which
        evicts parked cached blocks first under pressure). Rows past ``n``
        (a sender's padding) go to the trash block. fp rows are cast to the
        pool's dtype on write. Returns the new ids in shipping order."""
        k, ks = split_pages(k)
        v, vs = split_pages(v)
        if (ks is not None) != self.quantized:
            raise ValueError("page dtype mismatch: shipment and pool must "
                             "both be quantized or both fp")
        new_blocks = self._allocator.allocate(n)
        self._write_rows(new_blocks + [self.trash_block] * (int(k.shape[1]) - n),
                         (k, v) if ks is None else (k, v, ks, vs))
        return new_blocks

    def write_blocks(self, blocks, k, v):
        """Write shipped page rows into the given block ids (a tp follower's
        share of an import the controller allocated), cast to the pool's
        dtype; no allocator state changes."""
        k, ks = split_pages(k)
        v, vs = split_pages(v)
        self._write_rows(list(blocks), (k, v) if ks is None else (k, v, ks, vs))

    def _write_rows(self, blocks, parts):
        idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
        for pool, part in zip(self._pools(), parts):
            pool.index_copy_(1, idx, part.to(self.device, pool.dtype))

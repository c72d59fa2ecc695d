"""FastGen-style serving engine (port of
``deepspeed_tpu/inference/v2/engine_v2.py``, mirroring reference
``deepspeed/inference/v2/engine_v2.py:30``).

``put(uids, tokens)`` schedules a mixed prefill/decode ragged batch and returns
next-token logits per sequence; ``query``/``can_schedule`` expose admission
control for an external scheduler (DeepSpeed-MII's SplitFuse role);
``flush`` retires a sequence and frees its KV blocks.

Speculative decode: ``put_verify_device`` runs the verify forward and
samples every column of each row's last ``k_max`` chunk positions;
``rollback`` and ``commit_prefix`` retire the rejected tail and the deferred
prefix-cache commit after the scheduler's accept walk. With telemetry on,
each forward is a ``serving/forward`` span, each accounted host fetch a
``host_sync`` count, and ``sample_kv_stats`` records the KV gauges.

Tensor parallelism (a model split over a ``tp`` group, ``tp_size`` > 1) runs
one controller, as the JAX package's one program does. On tp rank 0 the
engine works as it does alone: allocator, prefix cache, admission, sampling
and telemetry, under whatever scheduler drives it. Every forward it runs is
first broadcast over the group (an op-code header, then the padded batch
arrays), so the ranks > 0, which hold only their share of the weights and
of the KV pools (``KV / tp`` heads under the same global block tables),
run the same forward on their shards from ``follow()``; the ranks' logits
are gathered on every rank, and only rank 0 samples. A verify forward
(speculative decode) is broadcast the same way with its column count; the
scheduler's drafts, accept walk and rollback, the draft-page class and the
prefix cache stay on rank 0, since they move only block ids and cursors,
and the next forward's block tables carry them to every rank. What moves
KV bytes is broadcast too: preemption's page swaps, and the host tier's
spills, restores and drops of parked prefix blocks (``_TPSpiller``), each
with its block ids, so that every rank moves its own heads' pages of the
same blocks. ``stop_followers()`` ends the followers' loops. So no decision
that reads the clock or a generator is taken on more than one rank, and the
ranks cannot diverge.

Page transfer for the serving fleet (``fleet/disagg.py``): ``export_pages_many``
detaches finished sequences' KV pages in one gather, ``import_pages_many``
binds a shipment under fresh ids and creates the sequences mid-stream;
``sequence_block_digests`` / ``held_prefix_lens`` are the two halves of the
delta-shipping digest exchange and ``peek_prefix`` the router's
prefix-affinity read.

Left for later slices: the flight-recorder collector (ROADMAP A15) and,
under tensor parallelism, page transfer (per-rank page shipping between
the tp groups of two replicas, ROADMAP A5 part 3).
"""

import dataclasses
from typing import Iterable, List, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch import resolve_device, telemetry
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.modules import module_registry as _mr
from deepspeed_tpu_torch.inference.v2.modules.heuristics import (instantiate_attention,
                                                                 instantiate_moe)
from deepspeed_tpu_torch.inference.v2.ragged.ragged_manager import DSStateManager
from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import RaggedBatchWrapper
from deepspeed_tpu_torch.inference.v2.sampling import sample_rows, verify_rows
from deepspeed_tpu_torch.models.mixtral import MixtralConfig
from deepspeed_tpu_torch.parallel.tensor_parallel import (TensorParallel,
                                                          broadcast_from_controller)
from deepspeed_tpu_torch.utils.logging import logger

# op codes of the controller's messages to the tp followers
_STOP, _FORWARD, _SWAP_OUT, _SWAP_IN, _SPILL, _RESTORE, _DROP = range(7)
_HEADER = 6          # int64 header: op, payload length, then four arguments


def pages_to(pages, device):
    """A page array (tensor or ``(data, scale)`` pair) on ``device``."""
    if isinstance(pages, tuple):
        return tuple(p.to(device) for p in pages)
    return pages.to(device)


@dataclasses.dataclass
class SchedulingResult:
    """Admission verdict (reference ``scheduling_utils.py``)."""
    success: bool
    reason: str = "ok"


class InferenceEngineV2:
    """Serve a Llama-family, Mixtral, Falcon/Phi or OPT model over a paged
    KV cache.

    Args:
        model: ``LlamaForCausalLM``, ``MixtralForCausalLM``,
            ``ParallelBlockForCausalLM`` or ``OPTForCausalLM``
            (``deepspeed_tpu_torch.models``) whose weights already lie on
            ``device``.
        config: ``RaggedInferenceEngineConfig`` or dict.
        forward_fn: the ragged forward (default: the factory's choice for
            the model family).
        verify_fn: the k-token verify forward for speculative decode
            (default: the factory's choice; None for Mixtral, Falcon/Phi
            and OPT).
        device: where the engine runs; default ``"cuda"``, which raises when
            no GPU is present.

    A model built with ``tp_size`` > 1 serves over its ``tp`` group
    (``model.tp``; ``engine_factory.build_engine`` attaches it), and
    ``tensor_parallel.tp_size`` must name the same size. Every rank of the
    group builds the engine; tp rank 0 is the controller and the others
    call ``follow()`` (module docstring).
    """

    def __init__(self, model, config=None, forward_fn=None, verify_fn=None,
                 device=None):
        if not isinstance(config, RaggedInferenceEngineConfig):
            config = RaggedInferenceEngineConfig(config or {})
        self._config = config
        self._device = resolve_device(device)
        self._model = model
        cfg = self._model_config = model.config
        weights_on = next(model.parameters()).device
        if weights_on != self._device:
            raise ValueError(f"model weights are on {weights_on}, the engine "
                             f"runs on {self._device}; move the model first")
        self._tp = tp = getattr(model, "tp", TensorParallel())
        self._check_tensor_parallel(config, tp)
        if forward_fn is None:
            from deepspeed_tpu_torch.inference.v2.engine_factory import resolve_forward_fn
            forward_fn = resolve_forward_fn(model)
        if verify_fn is None:
            from deepspeed_tpu_torch.inference.v2.engine_factory import resolve_verify_fn
            verify_fn = resolve_verify_fn(model)
        self._ragged_forward = forward_fn
        self._verify_forward = verify_fn
        if config.speculative.enabled and verify_fn is None:
            raise ValueError(
                "speculative.enabled requires a verify forward; "
                f"{type(cfg).__name__} has none (resolve_verify_fn)")
        mods = config.modules
        if mods.linear != "auto":
            raise _mr.UnsupportedModuleError(
                "modules.linear pins apply to quantized serving; the v2 "
                "ragged engine has no quantized linear to swap")
        is_moe = isinstance(cfg, MixtralConfig)
        if mods.moe != "auto" and not is_moe:
            # only the Mixtral forward routes through an expert FFN; a moe
            # pin on a dense model would install but never be read
            raise _mr.UnsupportedModuleError(
                f"modules.moe pinned to {mods.moe!r} but "
                f"{type(cfg).__name__} has no MoE layer to swap")
        sm, kvc = config.state_manager, config.kv_cache
        heads, kv_heads = model.plan.heads, model.plan.kv_heads
        # module choices are validated before the KV pool is allocated
        self._attention_impl, self._attention = instantiate_attention(
            (1, 1, heads, cfg.head_dim), (1, kv_heads, kvc.block_size, cfg.head_dim),
            preference=mods.attention)
        if mods.attention == "dense":
            logger.info(f"modules.attention pinned to 'dense' by config: "
                        f"attention runs its plain PyTorch version on "
                        f"{self._device}, not the kernel")
        self._moe_impl, self._forward_kw = None, {}
        if is_moe:
            self._moe_impl, moe = instantiate_moe(
                cfg.hidden_size, model.plan.ffn, preference=mods.moe)
            self._forward_kw["moe"] = moe
            if mods.moe == "einsum":
                logger.info(f"modules.moe pinned to 'einsum' by config: the "
                            f"expert FFN runs the plain dense dispatch on "
                            f"{self._device}, not the kernel")
        num_blocks = sm.num_kv_blocks
        if tp.size > 1 and num_blocks is None:
            # every rank's pools hold the same global block ids: size them
            # by the rank with the least free memory
            n = torch.tensor([DSStateManager._blocks_from_memory_budget(
                cfg.num_hidden_layers, kv_heads, cfg.head_dim, kvc, self._device,
                kv_dtype=sm.kv_dtype)], dtype=torch.int64, device=self._device)
            torch.distributed.all_reduce(n, op=torch.distributed.ReduceOp.MIN,
                                         group=tp.group)
            num_blocks = int(n.item())
        self._state = DSStateManager(config, cfg.num_hidden_layers, kv_heads,
                                     cfg.head_dim, self._device, num_blocks=num_blocks)
        self._state.kv_cache.set_host_fetch(self.host_fetch)
        if tp.size > 1 and self._state.prefix_cache is not None \
                and sm.host_kv_blocks > 0 and self.is_controller:
            self._state.prefix_cache.bind_spiller(_TPSpiller(self))
        self._max_blocks_per_seq = -(-sm.max_context // kvc.block_size)
        self._host_sync_count = 0
        logger.info(f"InferenceEngineV2 on {self._device}: "
                    f"S<={sm.max_ragged_sequence_count} "
                    f"tokens<={sm.max_ragged_batch_size} "
                    f"context<={sm.max_context} "
                    f"attention={self._attention_impl}"
                    + (f" moe={self._moe_impl}" if self._moe_impl else "")
                    + (f" tp rank {tp.rank} of {tp.size}" if tp.size > 1 else ""))

    def _check_tensor_parallel(self, config, tp):
        """Refuse a config whose ``tp_size`` is not the model's split (the
        model's ``TPPlan`` refused what it cannot cut when it was built)."""
        want = int(dict(config.tensor_parallel).get("tp_size", 1))
        if want != tp.size:
            raise ValueError(
                f"tensor_parallel.tp_size is {want} but the model is split over "
                f"{tp.size} rank(s); build the engine with engine_factory.build_engine")

    # -- tensor parallelism: the controller and its followers ----------------
    @property
    def tensor_parallel(self) -> TensorParallel:
        """The ``tp`` group this engine serves over (one rank: none)."""
        return self._tp

    @property
    def is_controller(self) -> bool:
        """Whether this rank schedules, samples and drives the forwards
        (tp rank 0, or the only rank)."""
        return self._tp.rank == 0

    def _send(self, op, args=(), payload=None):
        """Controller: broadcast one message to the followers."""
        n = 0 if payload is None else int(payload.numel())
        header = torch.tensor([op, n, *args] + [0] * (_HEADER - 2 - len(args)),
                              dtype=torch.int64, device=self._device)
        broadcast_from_controller(header, self._tp)
        if n:
            broadcast_from_controller(payload.to(self._device, torch.int32), self._tp)

    def _receive(self):
        """Follower: the controller's next message, (op, args, payload)."""
        header = torch.empty(_HEADER, dtype=torch.int64, device=self._device)
        broadcast_from_controller(header, self._tp)
        op, n, *args = header.tolist()
        payload = None
        if n:
            payload = torch.empty(n, dtype=torch.int32, device=self._device)
            broadcast_from_controller(payload, self._tp)
        return op, args, payload

    def follow(self):
        """Run on every tp rank > 0: serve the controller's broadcast
        forwards (plain and verify), page swaps and host-tier moves on this
        rank's shards until the controller calls ``stop_followers()``.
        Returns the number of forwards run."""
        if self.is_controller:
            raise RuntimeError("tp rank 0 is the controller; only ranks > 0 follow")
        kv, swapped, spilled, forwards = self._state.kv_cache, {}, {}, 0
        while True:
            op, args, payload = self._receive()
            if op == _STOP:
                return forwards
            if op == _FORWARD:
                S, Q, MB, verify_k = args
                sizes = (S * Q, S, S, S * MB)
                tokens, q_len, seen, tables = torch.split(payload, sizes)
                self._run_forward({"tokens": tokens.view(S, Q), "q_len": q_len,
                                   "seen": seen, "block_tables": tables.view(S, MB)},
                                  verify_k or None)
                forwards += 1
            elif op == _SWAP_OUT:
                swapped[args[0]] = kv.read_pages(payload.tolist())
            elif op == _SWAP_IN:
                kv.write_pages(payload.tolist(), swapped.pop(args[0]))
            elif op == _SPILL:
                spilled[args[0]] = kv.spill_block(args[1])
            elif op == _RESTORE:
                kv.restore_block(spilled.pop(args[0]), args[1])
            elif op == _DROP:
                spilled.pop(args[0])
            else:
                raise RuntimeError(f"unknown op {op} from the tp controller")

    def stop_followers(self):
        """Controller: end the followers' ``follow()`` loops (no-op without
        tensor parallelism)."""
        if self._tp.size > 1:
            self._send(_STOP)

    def _require_controller(self):
        if not self.is_controller:
            raise RuntimeError(f"tp rank {self._tp.rank} follows the controller: "
                               "call follow() on it")

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def attention_impl(self) -> str:
        """Registry name of the attention this engine runs."""
        return self._attention_impl

    @property
    def moe_impl(self):
        """Registry name of the expert-FFN dispatch this engine runs, or
        None for a model without MoE layers."""
        return self._moe_impl

    # -- accounted host fetch ----------------------------------------------
    @property
    def host_sync_count(self) -> int:
        """Device->host syncs this engine has performed. One decode round
        through the scheduler costs exactly one (the sampled-ids fetch)."""
        return self._host_sync_count

    def host_fetch(self, value, what: str):
        """THE accounted device->host boundary for serving: every hot-path
        transfer funnels through here so ``host_sync_count`` audits the
        per-round sync budget. Returns a CPU tensor."""
        self._host_sync_count += 1
        tm = telemetry.get_telemetry()
        if tm.enabled:
            tm.count("host_sync", what=what)
        return value.detach().to("cpu")

    # -- admission control (reference engine_v2.py:158-241) ----------------
    @property
    def free_blocks(self):
        return self._state.free_blocks

    # -- prefix caching (ragged/prefix_cache.py) ---------------------------
    @property
    def prefix_caching(self) -> bool:
        return self._state.prefix_cache is not None

    def match_prefix(self, uid: int, prompt_tokens) -> int:
        """Longest-cached-prefix match at sequence creation: creates the
        sequence holding the shared blocks and returns the matched token
        count (0 = miss or caching disabled). Schedulers advance their
        prefill cursor past the return value."""
        return self._state.match_prefix(uid, prompt_tokens)

    def peek_prefix(self, prompt_tokens) -> int:
        """How many prompt tokens a cached prefix would cover, without
        creating a sequence or taking references (a pure read): the fleet
        router's prefix-affinity signal."""
        cache = self._state.prefix_cache
        if cache is None:
            return 0
        blocks, _ = cache.lookup_chain(prompt_tokens)
        return len(blocks) * cache.block_size

    def query(self, uid: int, max_request_tokens: int,
              max_request_blocks: int) -> Tuple[int, int]:
        """How many tokens/blocks this sequence could schedule right now."""
        seq = self._state.get_sequence(uid)
        seen = seq.seen_tokens if seq else 0
        have_blocks = seq.cur_allocated_blocks if seq else 0
        bs = self._state.kv_block_size
        token_room = self._config.state_manager.max_context - seen
        block_room = have_blocks * bs - seen + min(max_request_blocks,
                                                   self.free_blocks) * bs
        return min(max_request_tokens, token_room, block_room), \
            min(max_request_blocks, self.free_blocks)

    def can_schedule(self, uids: Iterable[int],
                     lengths: Iterable[int]) -> SchedulingResult:
        uids, lengths = list(uids), list(lengths)
        sm = self._config.state_manager
        if len(set(uids)) != len(uids):
            return SchedulingResult(False, "duplicate uids in batch")
        if len(uids) > sm.max_ragged_sequence_count:
            return SchedulingResult(False, "too many sequences")
        if sum(lengths) > sm.max_ragged_batch_size:
            return SchedulingResult(False, "too many tokens")
        need, new_seqs = 0, 0
        for uid, n in zip(uids, lengths):
            seq = self._state.get_sequence(uid)
            seen = seq.seen_tokens if seq else 0
            if seq is not None and seq.is_swapped:
                # its KV lives in the host tier: attending would silently read
                # zeroed blocks — the caller must resume() first
                return SchedulingResult(False, f"uid {uid} is swapped out")
            if seq is None:
                new_seqs += 1
            if seen + n > sm.max_context:
                return SchedulingResult(False, f"uid {uid} exceeds max_context")
            have = seq.cur_allocated_blocks if seq else 0
            need += self._state.blocks_needed_for(seen, have, n,
                                                  self._state.kv_block_size)
        if self._state.n_tracked_sequences + new_seqs > sm.max_tracked_sequences:
            return SchedulingResult(False, "too many tracked sequences")
        if need > self.free_blocks:
            return SchedulingResult(False, "not enough KV blocks")
        return SchedulingResult(True)

    def get_remaining_block_capacity(self, uid: int) -> int:
        seq = self._state.get_sequence(uid)
        if seq is None:
            return 0
        return seq.cur_allocated_blocks * self._state.kv_block_size - seq.seen_tokens

    # -- serving (reference engine_v2.py:107) ------------------------------
    def _forward_device(self, batch_uids: List[int],
                        batch_tokens: List[np.ndarray], verify_k: int = None,
                        defer_commit=()):
        """Run one ragged forward; returns the FULL padded [S_bucket, vocab]
        fp32 logits on the device (no host transfer).

        ``verify_k``: when set, run the verify forward instead (the same
        trunk) and return [S_bucket, verify_k, vocab] logits of each row's
        last ``verify_k`` chunk positions. ``defer_commit``: uids whose
        prefix-cache block commit waits for the scheduler's accept walk
        (speculating rows: a rejected draft must be rolled back before any
        block digest is registered, or it would poison the shared chain
        cache; the scheduler calls ``commit_prefix`` afterwards)."""
        self._require_controller()
        verdict = self.can_schedule(batch_uids, [len(t) for t in batch_tokens])
        if not verdict.success:
            raise RuntimeError(f"cannot schedule batch: {verdict.reason}")
        if verify_k is not None and self._verify_forward is None:
            raise RuntimeError("no verify forward for this model family")
        tm = telemetry.get_telemetry()
        sp = tm.span("serving/forward", seqs=len(batch_uids),
                     tokens=int(sum(len(t) for t in batch_tokens))) \
            if tm.enabled else None
        sm = self._config.state_manager
        kv = self._state.kv_cache
        wrapper = RaggedBatchWrapper(sm.max_ragged_sequence_count,
                                     sm.max_ragged_batch_size,
                                     self._max_blocks_per_seq, kv.trash_block)
        caching = self._state.prefix_cache is not None
        for uid, toks in zip(batch_uids, batch_tokens):
            seq = self._state.get_or_create_sequence(uid)
            self._state.ensure_capacity(seq, len(toks))
            seq.in_flight_tokens = len(toks)
            if caching:
                seq.tokens.extend(int(t) for t in toks)
            wrapper.insert_sequence(uid, np.asarray(toks, np.int32),
                                    seq.seen_tokens, seq.kv_blocks)
        arrays = {k: torch.from_numpy(a).to(self._device)
                  for k, a in wrapper.build().items()}
        if self._tp.size > 1:
            S, Q = arrays["tokens"].shape
            self._send(_FORWARD, (S, Q, arrays["block_tables"].shape[1], verify_k or 0),
                       torch.cat([arrays[k].reshape(-1) for k in ("tokens", "q_len", "seen",
                                                                  "block_tables")]))
        logits = self._run_forward(arrays, verify_k)
        for uid in batch_uids:
            seq = self._state.get_sequence(uid)
            seq.post_forward()
            if caching and uid not in defer_commit:
                # register blocks as they FILL (not at flush) so concurrent
                # requests sharing a prefix hit as early as possible
                self._state.commit_cached_blocks(seq)
        if sp is not None:
            sp.end(logits)  # synchronises only when sample_sync is on
        return logits

    def _run_forward(self, arrays, verify_k=None):
        """The ragged (or verify) forward over padded batch arrays; on every
        tp rank, the same call."""
        batch = (self._model, self._state.kv_cache, arrays["tokens"], arrays["q_len"],
                 arrays["seen"], arrays["block_tables"])
        if verify_k is not None:
            return self._verify_forward(*batch, int(verify_k), attention=self._attention)
        return self._ragged_forward(*batch, attention=self._attention, **self._forward_kw)

    def put(self, batch_uids: List[int],
            batch_tokens: List[np.ndarray]) -> np.ndarray:
        """Run one ragged forward; returns [len(uids), vocab] next-token logits."""
        logits = self._forward_device(batch_uids, batch_tokens)
        return self.host_fetch(logits[:len(batch_uids)],
                               "serving/logits").numpy()

    def put_sampled_device(self, batch_uids: List[int],
                           batch_tokens: List[np.ndarray],
                           temperatures, top_ks, top_ps, seeds, positions):
        """``put_sampled`` without the final host fetch: returns the
        [S-bucket] int32 ids as a DEVICE tensor (rows past ``len(uids)`` are
        padding)."""
        logits = self._forward_device(batch_uids, batch_tokens)
        return sample_rows(logits, temperatures, top_ks, top_ps,
                           [int(s) & 0x7FFFFFFF for s in seeds], positions)

    def put_sampled(self, batch_uids: List[int],
                    batch_tokens: List[np.ndarray],
                    temperatures, top_ks, top_ps, seeds,
                    positions) -> np.ndarray:
        """One ragged forward + on-device sampling; returns [len(uids)] int32
        token ids. The host never sees the logits — 4 bytes per sequence
        cross to the host per decode step. Rows mid-prefill sample garbage
        by construction; callers discard those ids."""
        ids = self.put_sampled_device(batch_uids, batch_tokens, temperatures,
                                      top_ks, top_ps, seeds, positions)
        return self.host_fetch(ids, "serving/sampled_ids").numpy()[:len(batch_uids)]

    # -- speculative decode (draft-then-verify) ----------------------------
    @property
    def verify_supported(self) -> bool:
        """Whether this engine's model family has a k-token verify forward
        (speculative decode needs it; see ``resolve_verify_fn``)."""
        return self._verify_forward is not None

    def put_verify_device(self, batch_uids: List[int],
                          batch_tokens: List[np.ndarray],
                          temperatures, top_ks, top_ps, seeds, positions,
                          k_max: int, defer_commit=()):
        """``put_sampled_device`` for a verify round: one forward through the
        same trunk, sampling target tokens at each row's last ``k_max``
        chunk positions (last-aligned: column ``k_max - 1`` is the row's
        ordinary last-token draw). ``positions`` gives each row's stream
        position for that final column; column ``c`` is then the token plain
        decode would emit at ``positions[s] - (k_max - 1) + c``. Returns
        padded [S-bucket, k_max] int32 ids on the device; the scheduler
        fetches them once a round and walks each row's accepted prefix on
        the host. ``defer_commit`` goes to ``_forward_device``."""
        logits = self._forward_device(batch_uids, batch_tokens,
                                      verify_k=int(k_max),
                                      defer_commit=defer_commit)
        return verify_rows(logits, temperatures, top_ks, top_ps,
                           [int(s) & 0x7FFFFFFF for s in seeds], positions)

    def rollback(self, uid: int, n_tokens: int) -> None:
        """Roll ``uid``'s paged cursor back ``n_tokens`` (the rejected tail
        of a verify chunk): tail blocks wholly past the new cursor are
        dereferenced; shared prefix blocks survive, this round's private
        allocations return to the pool."""
        self._state.rollback_sequence(uid, n_tokens)

    def commit_prefix(self, uid: int) -> None:
        """Run the deferred prefix-cache block commit of a speculating row
        (after the accept walk and rollback, so only verified tokens enter
        the chain-digest cache). No-op when caching is off."""
        if self._state.prefix_cache is not None:
            seq = self._state.get_sequence(uid)
            if seq is not None:
                self._state.commit_cached_blocks(seq)

    def flush(self, uid: int) -> None:
        """Retire a sequence, freeing its KV blocks (reference :242)."""
        self._state.flush_sequence(uid)

    def kv_stats(self):
        """Pure host-side KV pool stats (occupancy, free blocks,
        fragmentation, swap counters). Never touches the device."""
        return self._state.kv_stats()

    def sample_kv_stats(self, point="step"):
        """``kv_stats``, recording the KV serving gauges when telemetry is
        on. Sync-free: the block bookkeeping lives on the host."""
        return self._state.sample_kv_stats(point=point)

    @property
    def kv_block_size(self) -> int:
        return self._state.kv_block_size

    # -- page transfer (prefill/decode disaggregation) ---------------------
    def _require_single_rank(self, what):
        if self._tp.size > 1:
            raise NotImplementedError(
                f"{what} under tensor parallelism (tp_size {self._tp.size}: per-rank page "
                "shipping between the tp groups of two replicas) is not ported yet; see "
                "ROADMAP.md queue A5 part 3")

    def export_pages(self, uid: int):
        """Detach ``uid``'s KV pages (copies on this engine's device) for
        shipping to a decode replica (``KVPageTransport``); releases the
        local sequence."""
        self._require_single_rank("page export")
        return self._state.export_sequence_pages(uid)

    def import_pages(self, uid: int, handle) -> int:
        """Bind shipped KV pages into this engine's pool under fresh
        refcount-1 block ids; creates the sequence mid-stream."""
        self._require_single_rank("page import")
        return self._state.import_sequence_pages(uid, handle)

    def export_pages_many(self, uids, skip=None):
        """Batched ``export_pages``: one gather covers every listed finished
        sequence (the fleet ships a whole round's handoffs as one transfer).
        ``skip`` maps uid -> leading full blocks to delta-ship (digest
        references instead of page bytes: the destination already holds
        them in its prefix cache)."""
        self._require_single_rank("page export")
        return self._state.export_sequences_pages(list(uids), skip=skip)

    def import_pages_many(self, handle) -> int:
        """Batched ``import_pages``; returns the pages bound."""
        self._require_single_rank("page import")
        return self._state.import_sequences_pages(handle)

    def sequence_block_digests(self, uids):
        """Per-uid full-block chain digests: the source half of the
        delta-shipping digest exchange (``{}`` without prefix caching)."""
        return self._state.sequence_block_digests(list(uids))

    def held_prefix_lens(self, chains):
        """Per-uid count of leading chain links this engine's prefix cache
        already holds: the destination half of the digest exchange."""
        return self._state.held_prefix_lens(chains)

    @property
    def kv_page_device(self) -> torch.device:
        """Where the KV pools live (the engine's device): the target a
        ``KVPageTransport`` moves shipped pages to. The JAX package's
        ``kv_page_sharding``; its ``place_kv`` has no counterpart, since the
        port allocates the pools on the engine's device at construction."""
        return self._state.kv_cache.device

    def warm_page_transfer(self, dst_engine, max_pages):
        """Run the page-transfer path toward ``dst_engine`` once before the
        serving clock starts: a gather of ``max_pages`` trash-block rows
        (capped at the destination's free blocks), its copy to the
        destination's device, and the scatter there, whose ids are freed at
        once. On two cards this is the first peer copy, which opens the
        peer mapping; on one card it warms the caching allocator's blocks
        of that size. No live KV is read and no ids stay held. The wire
        codec needs no warm-up of its own: it stages through pageable host
        memory."""
        dst = dst_engine._state.kv_cache
        n = min(int(max_pages), dst.free_blocks)
        if n < 1:
            return
        src = self._state.kv_cache
        k, v = src.export_blocks([src.trash_block] * n)
        k, v = pages_to(k, dst.device), pages_to(v, dst.device)
        dst.free(dst.import_blocks(k, v, n))

    # -- KV host swap (ZeRO-Inference KV offload; scheduler preemption) ----
    def preempt(self, uid: int) -> None:
        """Copy ``uid``'s KV cache to host memory, freeing its device blocks
        for other sequences; generation state is preserved. The tp
        followers copy their shards of the same pages."""
        seq = self._state.get_sequence(uid)
        if self._tp.size > 1 and seq is not None and not seq.is_swapped:
            self._send(_SWAP_OUT, (uid,), torch.tensor(seq.kv_blocks, dtype=torch.int32))
        self._state.swap_out_sequence(uid)

    def resume(self, uid: int) -> None:
        """Restore a preempted sequence's KV into fresh device blocks (on
        every tp rank, the same blocks)."""
        seq = self._state.get_sequence(uid)
        swapped = seq is not None and seq.is_swapped
        self._state.swap_in_sequence(uid)
        if self._tp.size > 1 and swapped:
            self._send(_SWAP_IN, (uid,), torch.tensor(seq.kv_blocks, dtype=torch.int32))

    def blocks_to_resume(self, uid: int) -> int:
        return self._state.blocks_to_resume(uid)

    @property
    def swap_stats(self):
        return {"swap_outs": self._state.swap_outs,
                "swap_ins": self._state.swap_ins}


class _TPSpiller:
    """The controller's host-tier spiller under tensor parallelism: the
    prefix cache's ``spill_block`` / ``restore_block`` / ``drop_block`` on
    this rank's pools, each first broadcast to the followers with its block
    id and a spill key, so that every rank spills, restores or drops its
    own heads' pages of the same block at the same point."""

    def __init__(self, engine):
        self._engine, self._kv = engine, engine._state.kv_cache
        self._next = 0

    def spill_block(self, block):
        key, self._next = self._next, self._next + 1
        self._engine._send(_SPILL, (key, block))
        return key, self._kv.spill_block(block)

    def restore_block(self, payload, block):
        key, local = payload
        self._engine._send(_RESTORE, (key, block))
        self._kv.restore_block(local, block)

    def drop_block(self, payload):
        self._engine._send(_DROP, (payload[0],))

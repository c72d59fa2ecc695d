"""SplitFuse continuous-batching scheduler over ``InferenceEngineV2`` (port of
``deepspeed_tpu/inference/v2/scheduler.py``).

Every forward carries a near-constant token budget by splitting long prompts
into chunks and fusing them with the single-token decodes of running
sequences — prefill never stalls decode latency. Pure host-side policy:
composes ragged batches, calls the engine, retires finished sequences. The
engine's admission control (``can_schedule``) stays the source of truth; the
scheduler only proposes.

Left for later slices: telemetry hooks and SLO classes (ROADMAP A4),
speculation (ROADMAP A3), and the fleet's ``adopt``/``readmit``/``on_finish``
and two-phase ``step_begin``/``step_finish`` (ROADMAP A8).
"""

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class _Request:
    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_token_id: Optional[int]
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    prefill_pos: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    preempted: bool = False  # KV host-swapped out (scheduler preemption)

    @property
    def prefilling(self):
        return self.prefill_pos < len(self.prompt)


class SplitFuseScheduler:
    """Greedy continuous batching with chunked (split) prefill.

    Args:
        engine: an ``InferenceEngineV2``.
        token_budget: max tokens per forward (defaults to the engine's
            ``max_ragged_batch_size``).
        device_sampling: True samples on the device (the host receives one
            int32 per sequence); False samples host-side from fetched logits.
    """

    def __init__(self, engine, token_budget=None, device_sampling=True):
        self._engine = engine
        sm = engine._config.state_manager
        self._budget = min(token_budget or sm.max_ragged_batch_size,
                           sm.max_ragged_batch_size)
        self._max_seqs = sm.max_ragged_sequence_count
        self._requests: Dict[int, _Request] = {}
        self._starved = 0  # consecutive rounds with nothing schedulable
        self._prefix_caching = bool(engine.prefix_caching)
        # prompt tokens actually run vs skipped via cached prefixes
        self.prefill_tokens_executed = 0
        self.prefill_tokens_saved = 0
        self._device_sampling = bool(device_sampling)
        self._active = 0  # submitted-but-unfinished count

    def submit(self, uid, prompt, max_new_tokens=16, eos_token_id=None,
               temperature=0.0, top_k=0, top_p=1.0, seed=None):
        """Queue a request. ``temperature`` 0.0 = greedy; otherwise
        per-request top-k/top-p sampling. ``seed=None`` draws a fresh random
        stream per request; pass an int for reproducible completions."""
        if uid in self._requests:
            raise ValueError(f"uid {uid} already submitted")
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        max_ctx = self._engine._config.state_manager.max_context
        if len(prompt) >= max_ctx:
            raise ValueError(f"prompt of {len(prompt)} tokens cannot fit "
                             f"max_context {max_ctx}")
        if seed is None:
            import secrets
            seed = secrets.randbits(31)
        self._requests[uid] = _Request(
            uid, prompt, int(max_new_tokens), eos_token_id,
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), seed=int(seed))
        self._active += 1

    def cancel(self, uid):
        """Withdraw a request: frees its KV blocks, device-resident or
        host-swapped. Call between steps. Returns True iff a live request
        was cancelled."""
        r = self._requests.get(uid)
        if r is None or r.done:
            return False
        r.done = True
        self._active -= 1
        if self._engine._state.get_sequence(uid) is not None:
            self._engine.flush(uid)
        return True

    def active_count(self):
        """Submitted-but-unfinished request count, O(1)."""
        return self._active

    @property
    def budget(self):
        """Per-forward token budget (SplitFuse)."""
        return self._budget

    @property
    def engine(self):
        return self._engine

    @property
    def has_work(self):
        return any(not r.done for r in self._requests.values())

    def _compose(self):
        """Pick (uids, token-chunks) for one forward under the budget.

        Decodes (1 token) first — they bound tail latency; leftover budget
        is split across pending prefills (the SplitFuse chunking)."""
        max_ctx = self._engine._config.state_manager.max_context
        uids, chunks, budget = [], [], self._budget
        for r in list(self._requests.values()):
            if r.done or r.prefilling or r.preempted or len(uids) >= self._max_seqs:
                continue
            pos = len(r.prompt) + len(r.generated)
            if pos >= max_ctx:
                # context capacity reached: retire with what it has — the
                # request can never schedule again and must not wedge others
                r.done = True
                self._active -= 1
                self._engine.flush(r.uid)
                continue
            if budget < 1:
                break
            uids.append(r.uid)
            chunks.append(np.asarray([r.generated[-1]], np.int32))
            budget -= 1
        for r in self._requests.values():
            if r.done or not r.prefilling or r.preempted or r.uid in uids:
                continue
            if len(uids) >= self._max_seqs or budget < 1:
                break
            room, _ = self._engine.query(r.uid, budget,
                                         self._engine.free_blocks)
            take = min(budget, room, len(r.prompt) - r.prefill_pos)
            if take < 1:
                continue
            if self._prefix_caching and r.prefill_pos == 0:
                # longest-cached-prefix match, deferred to the moment the
                # first chunk actually schedules — by then earlier requests
                # have committed their blocks
                matched = self._engine.match_prefix(r.uid, r.prompt)
                if matched:
                    r.prefill_pos = matched
                    self.prefill_tokens_saved += matched
                    take = min(budget, room, len(r.prompt) - r.prefill_pos)
            uids.append(r.uid)
            chunks.append(r.prompt[r.prefill_pos:r.prefill_pos + take])
            budget -= take
        return uids, chunks

    def _try_resume(self):
        """Swap preempted sequences back in (oldest first) while device
        blocks allow. A sequence only resumes when it can ALSO schedule its
        next chunk afterwards, or it would re-preempt immediately."""
        state = self._engine._state
        for r in list(self._requests.values()):
            if r.done or not r.preempted:
                continue
            need = self._engine.blocks_to_resume(r.uid)
            seq = state.get_sequence(r.uid)
            if seq is None:
                r.preempted = False
                continue
            grow = state.blocks_needed_for(seq.seen_tokens, need, 1,
                                           state.kv_block_size)
            if need and self._engine.free_blocks >= need + grow:
                self._engine.resume(r.uid)
                r.preempted = False

    def _preempt_for_progress(self):
        """KV pressure relief: push the request holding the most blocks out
        to host memory so someone else can run; its cache is restored later,
        not recomputed. Returns True if a sequence was preempted. Idle
        prefix-cached blocks are evicted by the allocator before this runs."""
        def blocks_of(r):
            seq = self._engine._state.get_sequence(r.uid)
            return len(seq.kv_blocks) if seq is not None else 0

        candidates = [r for r in self._requests.values()
                      if not r.done and not r.preempted and blocks_of(r) > 0]
        active = sum(1 for r in self._requests.values()
                     if not r.done and not r.preempted)
        if len(candidates) < 1 or active < 2:
            return False  # alone: preempting would free blocks we then re-need
        victim = max(candidates, key=blocks_of)
        self._engine.preempt(victim.uid)
        victim.preempted = True
        return True

    def step(self):
        """One scheduling round + forward. Returns uids finished this round."""
        self._try_resume()
        uids, chunks = self._compose()
        if not uids:
            if any(not r.done and r.preempted for r in self._requests.values()):
                self._starved += 1
                if self._starved > 3:
                    raise RuntimeError(
                        f"no schedulable work for {self._starved} rounds: "
                        f"preempted sequence(s) cannot be resumed (KV cache "
                        f"too small for the request?)")
            return []
        # shrink the proposal until the engine admits it (KV pressure):
        # whole chunks drop largest-first and RE-validate
        while uids:
            verdict = self._engine.can_schedule(uids, [len(c) for c in chunks])
            if verdict.success:
                break
            biggest = int(np.argmax([len(c) for c in chunks]))
            uids.pop(biggest)
            chunks.pop(biggest)
        if not uids:
            self._starved += 1
            if self._preempt_for_progress():
                self._starved = 0
                return []
            if self._starved > 3:
                raise RuntimeError(
                    f"no schedulable work for {self._starved} rounds: "
                    f"{verdict.reason} (KV cache too small for any request?)")
            return []
        self._starved = 0
        if self._device_sampling:
            reqs = [self._requests[u] for u in uids]
            ids = self._engine.put_sampled_device(
                uids, chunks,
                temperatures=[r.temperature for r in reqs],
                top_ks=[r.top_k for r in reqs],
                top_ps=[r.top_p for r in reqs],
                seeds=[r.seed for r in reqs],
                positions=[len(r.generated) for r in reqs])
            # the only device sync of the round
            ids = self._engine.host_fetch(ids, "scheduler/sampled_ids").numpy()
            logits = None
        else:
            logits = self._engine.put(uids, chunks)
        finished = []
        for row, uid in enumerate(uids):
            r = self._requests[uid]
            if r.prefilling:
                self.prefill_tokens_executed += len(chunks[row])
                r.prefill_pos += len(chunks[row])
                if r.prefilling:
                    continue  # mid-prompt ids/logits are not a next token
            r.generated.append(int(ids[row]) if logits is None
                               else self._sample(r, logits[row]))
            if (r.eos_token_id is not None and
                    r.eos_token_id == r.generated[-1]) or \
                    len(r.generated) >= r.max_new_tokens:
                r.done = True
                self._active -= 1
                self._engine.flush(uid)
                finished.append(uid)
        return finished

    def _sample(self, r, row_logits):
        """Per-request sampling, host-side (``device_sampling=False``).
        Deterministic per (seed, position)."""
        if r.temperature == 0.0:
            return int(np.argmax(row_logits))
        logits = np.asarray(row_logits, np.float64) / r.temperature
        if r.top_k and r.top_k > 0:
            kth = np.sort(logits)[-r.top_k]
            logits = np.where(logits < kth, -1e9, logits)
        if r.top_p < 1.0:
            order = np.argsort(logits)[::-1]
            probs = np.exp(logits[order] - logits[order][0])
            probs /= probs.sum()
            cum = np.cumsum(probs)
            cutoff_idx = int(np.sum(cum < r.top_p))  # always keep the top token
            cutoff = logits[order][cutoff_idx]
            logits = np.where(logits < cutoff, -1e9, logits)
        p = np.exp(logits - logits.max())
        p /= p.sum()
        rng = np.random.default_rng((r.seed << 20) + len(r.generated))
        return int(rng.choice(len(p), p=p))

    def results(self):
        """Generated tokens so far, {uid: int32 array}."""
        return {uid: np.asarray(r.generated, np.int32)
                for uid, r in self._requests.items()}

    def run_to_completion(self, max_rounds=10000):
        for _ in range(max_rounds):
            if not self.has_work:
                break
            self.step()
        else:
            raise RuntimeError("scheduler did not converge")
        return self.results()

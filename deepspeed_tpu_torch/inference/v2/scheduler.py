"""SplitFuse continuous-batching scheduler over ``InferenceEngineV2`` (port of
``deepspeed_tpu/inference/v2/scheduler.py``).

Every forward carries a near-constant token budget by splitting long prompts
into chunks and fusing them with the single-token decodes of running
sequences — prefill never stalls decode latency. Pure host-side policy:
composes ragged batches, calls the engine, retires finished sequences. The
engine's admission control (``can_schedule``) stays the source of truth; the
scheduler only proposes.

Speculative decode (``speculative.enabled``): decode rows carry
``[last_token] + drafts`` as a chunk through the verify forward; the accept
walk keeps the drafts that equal the targets, the rejected tail rolls the
paged cursor back, and the deferred prefix-cache commit runs after it.

Every lifecycle transition feeds the serving telemetry when it is enabled
(submit -> queued -> prefill -> decode / speculate -> finish / evict, plus
preempt / resume): TTFT / TPOT / e2e / queue-wait histograms, per-request
Chrome-trace lanes and flows, SLO-class attainment, and per-round gauges
(token-budget use, running / waiting / preempted, the KV gauges, the
speculation gauges). Disabled, every hook is one boolean check: no clock
read, no allocation in the telemetry core.

The serving fleet drives the scheduler through ``adopt`` (a request whose
KV pages were shipped in mid-generation), ``readmit`` (one that lost its
pages: its committed tokens re-prefill and the seeded stream resumes at the
same position), the ``on_finish`` hook (a prefill replica hands a request
off instead of flushing it), the load signals (``active_count``,
``kv_stats``, ``peek_prefix``, ``tokens_per_round``, ``drain_terminal``) and
the two-phase round: ``step_begin`` composes the round and launches the
forward and the device sampling without a host sync, ``step_finish`` makes
the round's one fetch. ``step()`` is ``step_finish(step_begin())``.
"""

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch import telemetry

# module-level alias, so tests can prove the disabled path never reads it
_now = time.perf_counter


def sheddable_classes(targets, burning):
    """Which SLO classes absorb preemption while ``burning`` classes exceed
    burn rate 1: every class whose TTFT target is strictly looser than the
    tightest burning class's. A batch class (30 s TTFT) sheds for a burning
    interactive class (4 s); the reverse never holds. ``targets`` is the
    ``telemetry.slo_class_targets()`` shape; classes without a TTFT target
    never shed for anyone (and nothing sheds for them)."""
    if not burning:
        return frozenset()
    tight = min((targets.get(c, {}).get("ttft_target_s") or float("inf"))
                for c in burning)
    out = set()
    for cls, spec in targets.items():
        if cls in burning:
            continue
        t = spec.get("ttft_target_s")
        if t is not None and t > tight:
            out.add(cls)
    return frozenset(out)


@dataclasses.dataclass
class _Request:
    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_token_id: Optional[int]
    slo_class: Optional[str] = None  # serving SLO class (config slo_classes)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    prefill_pos: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)
    # sampling-stream offset of a re-admitted request: it already emitted
    # ``pos_offset`` tokens on a replica that died, so every sample here
    # draws at position ``len(generated) + pos_offset``, the position the
    # uninterrupted stream would use (bit-exact recovery)
    pos_offset: int = 0
    done: bool = False
    preempted: bool = False  # KV host-swapped out (scheduler preemption)
    # serving-telemetry timestamps (perf_counter; 0.0 = not yet / disabled)
    submit_ts: float = 0.0
    first_sched_ts: float = 0.0
    last_token_ts: float = 0.0

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
            int32 per sequence, or per verify column); False samples
            host-side from fetched logits. Speculation needs True.
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
        # draft-then-verify decode: off, every branch below is one bool test
        spec_cfg = engine._config.speculative
        self._spec = bool(spec_cfg.enabled)
        self._drafter = None
        self._kmax = 0
        if self._spec:
            if not self._device_sampling:
                raise ValueError(
                    "speculative decode requires device_sampling=True "
                    "(the verify sampler is the on-device k-token path)")
            if not engine.verify_supported:
                raise ValueError(
                    "speculative decode requires an engine with a verify "
                    "forward (engine_factory.resolve_verify_fn)")
            from deepspeed_tpu_torch.inference.v2.speculative import NgramDrafter
            self._drafter = NgramDrafter(spec_cfg.ngram_max)
            self._max_drafts = max(1, int(spec_cfg.max_draft_tokens))
            # verify width: the power-of-two bucket holding drafts + 1
            self._kmax = 1
            while self._kmax < self._max_drafts + 1:
                self._kmax *= 2
        # speculation counters: plain ints, always on
        self.speculated_tokens = 0
        self.accepted_tokens = 0
        self.rejected_tokens = 0
        # EWMA of tokens committed per decode row per round
        self._tokens_per_round_ewma = 1.0
        # preemptions whose victim the SLO burn-rate gauges chose
        self.slo_preemptions = 0
        # terminal outcomes beyond plain finish (evict / cancel), drained by
        # the fleet router so its backlog model retires on every terminal
        # event: plain list appends, always on
        self.terminal_events = []
        # prefill/decode disaggregation hook: called as on_finish(sched, req)
        # the moment a request completes, before the sequence flushes; a
        # truthy return means ownership (KV pages and the remaining decode)
        # moved to another scheduler, which skips the flush and the terminal
        # telemetry here
        self.on_finish = None
        # per-class SLO latency targets (config slo_classes), installed into
        # telemetry once here so slo_observe knows them; requests tag
        # themselves through submit(..., slo_class=...)
        self._slo_classes = dict(engine._config.slo_classes or {})
        if self._slo_classes:
            telemetry.set_slo_classes(self._slo_classes)

    def submit(self, uid, prompt, max_new_tokens=16, eos_token_id=None,
               temperature=0.0, top_k=0, top_p=1.0, seed=None,
               slo_class=None):
        """Queue a request. ``temperature`` 0.0 = greedy; otherwise
        per-request top-k/top-p sampling. ``seed=None`` draws a fresh random
        stream per request; pass an int for reproducible completions.
        ``slo_class`` tags the request's latency samples against that
        class's targets (config ``slo_classes``)."""
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
        if slo_class is not None and self._slo_classes \
                and slo_class not in self._slo_classes:
            raise ValueError(f"unknown slo_class {slo_class!r} (configured: "
                             f"{sorted(self._slo_classes)})")
        req = _Request(uid, prompt, int(max_new_tokens), eos_token_id,
                       slo_class=slo_class, temperature=float(temperature),
                       top_k=int(top_k), top_p=float(top_p), seed=int(seed))
        tm = telemetry.get_telemetry()
        if tm.enabled:
            req.submit_ts = _now()
            tm.serving_event("submitted")
            tm.record_request_phase(uid, "submit", req.submit_ts,
                                    prompt_tokens=len(prompt))
            tm.record_request_flow(uid, "submit", prompt_tokens=len(prompt))
        self._requests[uid] = req
        self._active += 1

    def adopt(self, uid, prompt, generated, max_new_tokens=16,
              eos_token_id=None, temperature=0.0, top_k=0, top_p=1.0,
              seed=0, submit_ts=0.0, last_token_ts=0.0, slo_class=None):
        """Adopt a mid-generation request whose KV pages were just imported
        into this scheduler's engine (prefill/decode disaggregation): the
        prompt is fully prefilled and ``generated`` holds the tokens the
        prefill side already sampled. Decode continues bit-exactly — device
        sampling is deterministic per (seed, position) and positions resume
        from ``len(generated)``. ``submit_ts``/``last_token_ts`` carry the
        originating timestamps through so e2e and TPOT histograms span the
        handoff instead of restarting at it."""
        if uid in self._requests:
            raise ValueError(f"uid {uid} already submitted")
        generated = [int(t) for t in generated]
        if not generated:
            raise ValueError("adopt requires at least one generated token")
        prompt = np.asarray(prompt, np.int32)
        seq = self._engine._state.get_sequence(uid)
        if seq is None or seq.seen_tokens != len(prompt):
            raise ValueError(
                f"uid {uid}: imported KV does not cover the prompt "
                f"(seen={seq.seen_tokens if seq else None}, "
                f"prompt={len(prompt)})")
        req = _Request(uid, prompt, int(max_new_tokens), eos_token_id,
                       slo_class=slo_class,
                       temperature=float(temperature), top_k=int(top_k),
                       top_p=float(top_p), seed=int(seed),
                       prefill_pos=len(prompt), generated=generated)
        req.submit_ts = float(submit_ts)
        req.last_token_ts = float(last_token_ts)
        tm = telemetry.get_telemetry()
        if tm.enabled:
            t = _now()
            req.first_sched_ts = t  # queue-wait was recorded at prefill
            tm.serving_event("adopted")
            tm.record_request_phase(uid, "adopt", t,
                                    seen_tokens=len(prompt),
                                    new_tokens=len(generated))
            tm.record_request_flow(uid, "adopt",
                                   new_tokens=len(generated))
        self._requests[uid] = req
        self._active += 1

    def readmit(self, uid, prompt, generated, max_new_tokens=16,
                eos_token_id=None, temperature=0.0, top_k=0, top_p=1.0,
                seed=0, submit_ts=0.0, last_token_ts=0.0, slo_class=None):
        """Re-admit a request that lost its KV mid-generation (replica loss
        or an exhausted handoff): unlike ``adopt``, NO pages exist here —
        the prompt plus every already-emitted token but the last re-prefill
        as an ordinary SplitFuse prompt (with prefix caching on, only the
        tail past the request's last committed prefix digest actually
        runs), and the deterministic sampling stream resumes at position
        ``len(generated)`` via ``pos_offset``, so the continuation is
        bit-exact with the uninterrupted run. ``max_new_tokens`` is the
        ORIGINAL quota; the emitted count is subtracted here."""
        if uid in self._requests:
            raise ValueError(f"uid {uid} already submitted")
        generated = [int(t) for t in generated]
        if not generated:
            raise ValueError("readmit requires at least one generated "
                             "token; resubmit the prompt instead")
        emitted = len(generated)
        if emitted >= int(max_new_tokens) or \
                (eos_token_id is not None and generated[-1] == eos_token_id):
            raise ValueError(f"uid {uid} is already complete "
                             f"({emitted} tokens)")
        prompt = np.asarray(prompt, np.int32)
        head = np.asarray(generated[:-1], np.int32)
        full = np.concatenate([prompt, head]) if emitted > 1 else prompt
        req = _Request(uid, full, int(max_new_tokens) - (emitted - 1),
                       eos_token_id, slo_class=slo_class,
                       temperature=float(temperature), top_k=int(top_k),
                       top_p=float(top_p), seed=int(seed),
                       generated=[generated[-1]], pos_offset=emitted - 1)
        req.submit_ts = float(submit_ts)
        req.last_token_ts = float(last_token_ts)
        tm = telemetry.get_telemetry()
        if tm.enabled:
            t = _now()
            tm.serving_event("readmitted")
            tm.record_request_phase(uid, "readmit", t,
                                    seen_tokens=len(full),
                                    new_tokens=emitted)
            tm.record_request_flow(uid, "readmit", new_tokens=emitted)
        self._requests[uid] = req
        self._active += 1

    def cancel(self, uid):
        """Withdraw a request: frees its KV blocks, device-resident or
        host-swapped, and records its terminal ``serving/e2e_s`` and
        ``req/cancel`` lane. Call between steps. Returns True iff a live
        request was cancelled."""
        r = self._requests.get(uid)
        if r is None or r.done:
            return False
        r.done = True
        self._active -= 1
        self.terminal_events.append((uid, "cancelled"))
        if self._engine._state.get_sequence(uid) is not None:
            self._engine.flush(uid)
        tm = telemetry.get_telemetry()
        if tm.enabled:
            t = _now()
            tm.record_hist("serving/e2e_s", t - (r.submit_ts or t))
            tm.serving_event("cancelled")
            tm.record_request_phase(uid, "cancel", t,
                                    new_tokens=len(r.generated))
            tm.record_request_flow(uid, "cancel", end=True)
        return True

    def active_count(self):
        """Submitted-but-unfinished request count, O(1)."""
        return self._active

    def drain_terminal(self):
        """Terminal outcomes beyond plain finish since the last call
        (``[(uid, "evicted" | "cancelled"), ...]``): the router retires its
        predicted-backlog rounds on these; finished uids retire through the
        ``step()`` return instead."""
        events, self.terminal_events = self.terminal_events, []
        return events

    def tokens_per_round(self):
        """EWMA of tokens committed per decode row per round, >= 1.0
        (exactly 1.0 without speculation): the SLO router's TTFT divisor."""
        return self._tokens_per_round_ewma

    def kv_stats(self):
        """This replica's host-side KV pool stats
        (``InferenceEngineV2.kv_stats``: occupancy, free blocks, swaps)."""
        return self._engine.kv_stats()

    def peek_prefix(self, prompt_tokens):
        """Cached-prefix coverage of a prompt, a pure read (the router's
        prefix affinity)."""
        return self._engine.peek_prefix(prompt_tokens)

    @property
    def max_context(self):
        return self._engine._config.state_manager.max_context

    def _burning_classes(self):
        """Classes whose live burn-rate gauge exceeds 1 (either metric).
        Telemetry off or no classes configured -> () — precedence simply
        disengages."""
        if not self._slo_classes:
            return ()
        tm = telemetry.get_telemetry()
        if not tm.enabled:
            return ()
        out = []
        for cls in self._slo_classes:
            for metric in ("ttft", "tpot"):
                v = tm.gauge_value(f"slo/{cls}/{metric}_burn_rate")
                if v is not None and v > 1.0:
                    out.append(cls)
                    break
        return out

    @property
    def budget(self):
        """Per-forward token budget (SplitFuse)."""
        return self._budget

    @property
    def engine(self):
        """The underlying ``InferenceEngineV2`` (page transfer, admission)."""
        return self._engine

    @property
    def has_work(self):
        return any(not r.done for r in self._requests.values())

    def _compose(self):
        """Pick (uids, token-chunks) for one forward under the budget.

        Decodes first — they bound tail latency — each with up to the
        verify width's drafts when speculating; leftover budget is split
        across pending prefills (the SplitFuse chunking)."""
        max_ctx = self._engine._config.state_manager.max_context
        tm = telemetry.get_telemetry()
        uids, chunks, budget = [], [], self._budget
        for r in list(self._requests.values()):
            if r.done or r.prefilling or r.preempted or len(uids) >= self._max_seqs:
                continue
            pos = len(r.prompt) + len(r.generated)
            if pos >= max_ctx:
                # context capacity reached: retire with what it has — the
                # request can never schedule again and must not wedge others.
                # This is its terminal event, so it records e2e and an evict
                # lane, or percentiles would drop the worst latencies.
                r.done = True
                self._active -= 1
                self.terminal_events.append((r.uid, "evicted"))
                self._engine.flush(r.uid)
                if tm.enabled:
                    t_evict = _now()
                    tm.record_hist("serving/e2e_s",
                                   t_evict - (r.submit_ts or t_evict))
                    tm.serving_event("evicted")
                    tm.record_request_phase(r.uid, "evict", t_evict,
                                            seen_tokens=pos)
                    tm.record_request_flow(r.uid, "evict", end=True)
                continue
            if budget < 1:
                break
            chunk = [r.generated[-1]]
            if self._spec:
                # drafts bounded by the verify width, the row's remaining
                # quota (tokens past max_new are wasted work), the context
                # roof (seen is pos - 1, so at most max_ctx - pos drafts fit)
                # and the round's token budget
                d_cap = min(self._max_drafts,
                            r.max_new_tokens - len(r.generated) - 1,
                            max_ctx - pos, budget - 1)
                if d_cap > 0:
                    chunk += self._drafter.draft(
                        list(r.prompt) + r.generated, d_cap)[:d_cap]
            uids.append(r.uid)
            chunks.append(np.asarray(chunk, np.int32))
            budget -= len(chunk)
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
            if self._prefix_caching and r.prefill_pos == 0 and \
                    (not r.generated or r.pos_offset):
                # longest-cached-prefix match, deferred to the moment the
                # first chunk actually schedules — by then earlier requests
                # have committed their blocks. A re-admitted request
                # (pos_offset) matches over prompt + its earlier tokens, so
                # only the tail past its last committed digest re-runs.
                matched = self._engine.match_prefix(r.uid, r.prompt)
                if tm.enabled:
                    tm.serving_event("prefix_hit" if matched
                                     else "prefix_miss")
                    if matched:
                        tm.serving_event("prefill_tokens_saved", n=matched)
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
        blocks allow. A sequence only resumes when it can also schedule its
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
                tm = telemetry.get_telemetry()
                if tm.enabled:
                    tm.serving_event("resumed")
                    tm.record_request_phase(r.uid, "resume", _now(),
                                            blocks=need)

    def _preempt_for_progress(self):
        """KV pressure relief: push the request holding the most blocks out
        to host memory so someone else can run; its cache is restored later,
        not recomputed. While an SLO class burns (burn rate > 1), rows of
        strictly looser classes go first. Returns True if a sequence was
        preempted. Idle prefix-cached blocks are evicted by the allocator
        before this runs."""
        def blocks_of(r):
            seq = self._engine._state.get_sequence(r.uid)
            return len(seq.kv_blocks) if seq is not None else 0

        candidates = [r for r in self._requests.values()
                      if not r.done and not r.preempted and blocks_of(r) > 0]
        active = sum(1 for r in self._requests.values()
                     if not r.done and not r.preempted)
        if len(candidates) < 1 or active < 2:
            return False  # alone: preempting would free blocks we then re-need
        slo_pick = False
        burning = self._burning_classes()
        if burning:
            shed = sheddable_classes(telemetry.slo_class_targets(), burning)
            preferred = [r for r in candidates
                         if r.slo_class is None or r.slo_class in shed]
            if preferred and len(preferred) < len(candidates):
                candidates = preferred
                slo_pick = True
        victim = max(candidates, key=blocks_of)
        if slo_pick:
            self.slo_preemptions += 1
        n_blocks = blocks_of(victim)
        self._engine.preempt(victim.uid)
        victim.preempted = True
        tm = telemetry.get_telemetry()
        if tm.enabled:
            if slo_pick:
                tm.serving_event("slo_preempted")
            tm.serving_event("preempted")
            tm.record_request_phase(victim.uid, "preempt", _now(),
                                    blocks=n_blocks)
        return True

    def step(self):
        """One scheduling round + forward. Returns uids finished this round."""
        pending = self.step_begin()
        return self.step_finish(pending) if pending is not None else []

    def step_begin(self):
        """Compose one round and launch its forward and device sampling
        without fetching the result (no host sync). Returns an opaque
        pending handle for ``step_finish``, or None when nothing was
        schedulable. A fleet stepping several replicas begins them all and
        then finishes them all, so one replica's host work overlaps the
        others' device work instead of waiting on each fetch in turn."""
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
            return None
        # shrink the proposal until the engine admits it (KV pressure):
        # drafts shed first — a speculating row trims back to its 1-token
        # chunk (``_try_resume`` gates resume on 1-token growth, so popping
        # the row instead would thrash preempt/resume) — then whole chunks
        # drop largest-first and re-validate
        while uids:
            verdict = self._engine.can_schedule(uids, [len(c) for c in chunks])
            if verdict.success:
                break
            if self._spec:
                spec_rows = [i for i, u in enumerate(uids)
                             if not self._requests[u].prefilling
                             and len(chunks[i]) > 1]
                if spec_rows:
                    trim = max(spec_rows, key=lambda i: len(chunks[i]))
                    chunks[trim] = chunks[trim][:1]
                    continue
            biggest = int(np.argmax([len(c) for c in chunks]))
            uids.pop(biggest)
            chunks.pop(biggest)
        if not uids:
            self._starved += 1
            if self._preempt_for_progress():
                self._starved = 0
                return None
            if self._starved > 3:
                raise RuntimeError(
                    f"no schedulable work for {self._starved} rounds: "
                    f"{verdict.reason} (KV cache too small for any request?)")
            return None
        self._starved = 0
        tm = telemetry.get_telemetry()
        enabled = tm.enabled
        t_fwd = 0.0
        sched_tokens = 0
        was_prefilling = None
        if enabled:
            t_fwd = _now()
            was_prefilling = [self._requests[u].prefilling for u in uids]
            for row, uid in enumerate(uids):
                r = self._requests[uid]
                sched_tokens += len(chunks[row])
                if r.first_sched_ts == 0.0:
                    r.first_sched_ts = t_fwd
                    if r.submit_ts:
                        tm.record_hist("serving/queue_wait_s",
                                       t_fwd - r.submit_ts)
                        tm.record_request_phase(uid, "queued", r.submit_ts,
                                                t_fwd - r.submit_ts)
                    tm.record_request_flow(uid, "prefill",
                                           tokens=len(chunks[row]))
        reqs = [self._requests[u] for u in uids]
        spec = self._spec
        logits = None
        if spec:
            # each row's last verify column samples at the next stream
            # position after its chunk (decode rows: len(generated) counts
            # chunk[0], the drafts follow), or at the first generated
            # position (prefill rows; mid-prompt rows discard theirs)
            positions = [len(r.generated) + r.pos_offset if r.prefilling
                         else len(r.generated) + len(c) - 1 + r.pos_offset
                         for r, c in zip(reqs, chunks)]
            # rows that can roll back commit their prefix-cache blocks only
            # after the accept walk
            defer = {u for u, c in zip(uids, chunks) if len(c) > 1}
            ids = self._engine.put_verify_device(
                uids, chunks,
                temperatures=[r.temperature for r in reqs],
                top_ks=[r.top_k for r in reqs],
                top_ps=[r.top_p for r in reqs],
                seeds=[r.seed for r in reqs],
                positions=positions, k_max=self._kmax, defer_commit=defer)
        elif self._device_sampling:
            ids = self._engine.put_sampled_device(
                uids, chunks,
                temperatures=[r.temperature for r in reqs],
                top_ks=[r.top_k for r in reqs],
                top_ps=[r.top_p for r in reqs],
                seeds=[r.seed for r in reqs],
                positions=[len(r.generated) + r.pos_offset for r in reqs])
        else:
            logits = self._engine.put(uids, chunks)
            ids = None
        return (uids, chunks, ids, logits, t_fwd, was_prefilling, sched_tokens)

    def step_finish(self, pending):
        """Fetch a launched round's sampled ids (the round's one device
        sync) and retire its tokens and finished requests. Returns the uids
        finished this round."""
        uids, chunks, ids, logits, t_fwd, was_prefilling, sched_tokens = pending
        tm = telemetry.get_telemetry()
        # t_fwd == 0.0: telemetry was off at launch, so the round stays dark
        enabled = tm.enabled and t_fwd > 0.0
        if ids is not None:
            ids = self._engine.host_fetch(ids, "scheduler/sampled_ids").numpy()
        spec = self._spec
        t_done = 0.0
        if enabled:
            t_done = _now()
            fwd_dur = t_done - t_fwd
            for row, uid in enumerate(uids):
                phase = "prefill" if was_prefilling[row] else \
                    ("speculate" if spec and len(chunks[row]) > 1 else "decode")
                tm.record_request_phase(uid, phase, t_fwd, fwd_dur,
                                        tokens=len(chunks[row]))
        finished = []
        # per-round speculation tallies (gauges + the EWMA)
        n_decode_rows = decode_committed = drafted = accepted = occ_cols = 0
        for row, uid in enumerate(uids):
            r = self._requests[uid]
            if r.prefilling:
                self.prefill_tokens_executed += len(chunks[row])
                r.prefill_pos += len(chunks[row])
                if r.prefilling:
                    continue  # mid-prompt ids/logits are not a next token
                if r.generated:
                    # a re-admitted row finishing its re-prefill: the
                    # stream's last committed token is already in
                    # ``generated`` (its context ends the rebuilt prompt),
                    # so this sample would duplicate it; decode resumes by
                    # feeding that token as an ordinary chunk next round
                    emitted = []
                else:
                    # the final prefill chunk: its last column is the row's
                    # ordinary last-token sample
                    emitted = [int(ids[row, -1])] if spec else \
                        [int(ids[row]) if logits is None
                         else self._sample(r, logits[row])]
            elif spec:
                # accept walk: target column c is the token plain decode
                # would emit after chunk position c; drafts match targets
                # one position earlier, so j accepted drafts let the row
                # emit j + 1 plain-stream tokens from one forward
                chunk = chunks[row]
                n_drafts = len(chunk) - 1
                n_decode_rows += 1
                occ_cols += len(chunk)
                targets = [int(t) for t in ids[row, self._kmax - len(chunk):]]
                j = 0
                while j < n_drafts and int(chunk[1 + j]) == targets[j]:
                    j += 1
                drafted += n_drafts
                accepted += j
                self.speculated_tokens += n_drafts
                self.accepted_tokens += j
                self.rejected_tokens += n_drafts - j
                emitted = targets[:j + 1]
                # truncate at the quota and at eos: tokens past either never
                # exist in the plain stream
                emitted = emitted[:r.max_new_tokens - len(r.generated)]
                if r.eos_token_id is not None and r.eos_token_id in emitted:
                    emitted = emitted[:emitted.index(r.eos_token_id) + 1]
                # the chunk wrote len(chunk) KV tokens; the plain stream
                # keeps len(emitted) of them (chunk[0] and the accepted
                # drafts; emitted[-1] is next round's chunk[0])
                rollback = len(chunk) - len(emitted)
                if rollback:
                    self._engine.rollback(uid, rollback)
                if n_drafts and self._prefix_caching:
                    self._engine.commit_prefix(uid)  # deferred past rollback
                decode_committed += len(emitted)
            else:
                emitted = [int(ids[row]) if logits is None
                           else self._sample(r, logits[row])]
            first = not r.generated
            r.generated.extend(emitted)
            if enabled:
                if first:
                    # TTFT spans submit -> first token; a request submitted
                    # before telemetry came on anchors at t_fwd
                    ttft = t_done - (r.submit_ts or t_fwd)
                    tm.record_hist("serving/ttft_s", ttft)
                    if r.slo_class:
                        tm.slo_observe(r.slo_class, "ttft", ttft)
                elif r.last_token_ts and emitted:
                    # the round's gap amortised over its emitted tokens, one
                    # histogram entry per token
                    gap = (t_done - r.last_token_ts) / len(emitted)
                    for _ in emitted:
                        tm.record_hist("serving/tpot_s", gap)
                    if r.slo_class:
                        tm.slo_observe(r.slo_class, "tpot", gap,
                                       n=len(emitted))
                r.last_token_ts = t_done
            if (r.eos_token_id is not None and
                    r.eos_token_id == r.generated[-1]) or \
                    len(r.generated) >= r.max_new_tokens:
                r.done = True
                self._active -= 1
                # disaggregation hook: a truthy return means the KV pages
                # and the remaining decode moved to another scheduler, whose
                # finish is the request's terminal event
                if self.on_finish is not None and self.on_finish(self, r):
                    continue
                self._engine.flush(uid)
                finished.append(uid)
                if enabled:
                    tm.record_hist("serving/e2e_s",
                                   t_done - (r.submit_ts or t_fwd))
                    tm.serving_event("finished")
                    tm.record_request_phase(uid, "finish", t_done,
                                            new_tokens=len(r.generated))
                    tm.record_request_flow(uid, "finish", end=True)
        if spec and n_decode_rows:
            # tokens committed per decode row per round (>= 1)
            self._tokens_per_round_ewma = max(1.0, (
                0.9 * self._tokens_per_round_ewma
                + 0.1 * (decode_committed / n_decode_rows)))
            if enabled:
                tm.serving_gauge("serving/verify_batch_occupancy",
                                 occ_cols / (n_decode_rows * self._kmax))
                if drafted:
                    tm.serving_gauge("serving/accept_rate",
                                     accepted / drafted)
                    tm.serving_event("speculated_tokens", n=drafted)
                    if drafted - accepted:
                        tm.serving_event("rejected_tokens",
                                         n=drafted - accepted)
        if enabled:
            running = waiting = preempted = 0
            uid_set = set(uids)
            for r in self._requests.values():
                if r.done:
                    continue
                if r.preempted:
                    preempted += 1
                elif r.uid in uid_set:
                    running += 1
                else:
                    waiting += 1
            tm.serving_gauge("serving/token_budget_util",
                             sched_tokens / self._budget)
            tm.serving_gauge("serving/running", running)
            tm.serving_gauge("serving/waiting", waiting)
            tm.serving_gauge("serving/preempted", preempted)
            self._engine.sample_kv_stats()
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
        rng = np.random.default_rng(
            (r.seed << 20) + len(r.generated) + r.pos_offset)
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

"""Prefill/decode disaggregation: specialized replicas + KV page shipping
(port of ``deepspeed_tpu/inference/v2/fleet/disagg.py``).

The splitwise/distserve-style specialization the ROADMAP names for the
millions-of-users path: PREFILL replicas run SplitFuse prompt chunks only
(their token budget is never taxed by decodes), and the moment a request's
first token is sampled its finished KV pages ship to a DECODE replica,
which continues generation without ever re-running prefill.

Mechanics in the port: replicas are (engine, scheduler) pairs inside one
process, each on a torch device of the fleet's list
(``replica_group.build_device_replica``), so the ship is an in-process copy
of the gathered page rows to the destination pool's device — a peer copy
over NVLink / PCIe between two cards (the reference's NVLink/NIXL page
transfer), nothing to move when both replicas share a card — with bytes and
latency recorded per handoff (``telemetry.record_handoff``).
Binding goes through the destination ``BlockedAllocator`` (refcount-1 ids
via ``import_pages``), and the decode scheduler ``adopt``s the request
mid-stream. Bit-exactness falls out of deterministic sampling: the decode
side inherits the request's (seed, position) stream and identical params,
so fleet output matches the monolithic single-replica path token for token
(pinned by tests/test_torch_fleet.py).

Handoff protocol (one request):

  1. router/``submit`` places the request on a prefill replica with
     ``max_new_tokens=1`` — SplitFuse runs the prompt chunks and samples
     exactly the first token.
  2. the scheduler's ``on_finish`` hook fires BEFORE the flush: if the
     request is truly done (wanted 1 token, or hit EOS) it finishes there;
     otherwise the hook picks the least-occupied decode replica that can
     bind the pages, ships, adopts, and returns True so the prefill side
     skips flush + terminal telemetry.
  3. the decode replica's next round carries the request as a plain decode
     row; its finish is the request's one terminal event.

Left for later slices: replicas at ``tp_size`` > 1 (ROADMAP A5 part 3) and
the flight-recorder collectors the JAX fleet registers (page census,
lifecycle, transport stats; ROADMAP A15).
"""

import functools
import secrets
import time

import numpy as np
import torch

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.inference.v2.engine_v2 import pages_to
from deepspeed_tpu_torch.inference.v2.fleet import lifecycle as lc
from deepspeed_tpu_torch.inference.v2.fleet import wire
from deepspeed_tpu_torch.inference.v2.fleet.wire import (WireCRCError,
                                                         WireVersionError)
from deepspeed_tpu_torch.inference.v2.replica_group import (_ModelCopies,
                                                            build_device_replica,
                                                            check_single_rank,
                                                            on_device)
from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.resilience.faults import InjectedFault
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.retry import RetryError, retry_call


def _nbytes(*pages):
    """Device bytes of page arrays (tensors or ``(data, scale)`` pairs)."""
    return sum(t.numel() * t.element_size()
               for p in pages for t in (p if isinstance(p, tuple) else (p,)))


def _settle(device):
    """Wait for ``device``'s current stream: a handoff's latency covers its
    copies, as the JAX package's ``block_until_ready`` makes it."""
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class HandoffError(RuntimeError):
    """A KV page handoff that could not complete after retries.

    ``stage`` is ``"transfer"`` (retries exhausted BEFORE the export — the
    source pages are still resident and must be flushed by the caller) or
    ``"bind"`` (the export already released the source pages, so no retry
    can help; the data is gone). Either way the fleet's recovery is the
    same: the request falls back to re-prefill on the decode side instead
    of the error raising through ``fleet.step()``."""

    def __init__(self, uids, stage, detail=""):
        super().__init__(f"handoff {stage} failed for uids {list(uids)}"
                         + (f": {detail}" if detail else ""))
        self.uids = list(uids)
        self.stage = stage


class KVPageTransport:
    """Ships a finished sequence's KV pages between replica engines.

    ``ship`` = export (device-side gather, source released) -> transport
    leg -> import (allocator bind). Two codecs:

    * ``codec="device"`` — the in-process path: one copy of the gathered page
      rows to the destination pool's device (a peer copy between cards; on
      one card the rows stay where the gather put them, which is safe
      because the gather copied).
    * ``codec="wire"`` — the serialized path (``fleet/wire.py``): the
      exported pages land on the host, frame as versioned + per-page-CRC32
      bytes (int8 pools byte-for-byte; fp pools quantized at the wire on the
      source device, kernel row 5), and parse back onto the destination
      device (dequantized there, row 6). This is the leg a cross-process
      fabric runs; in-process it exists so the exact bytes a socket would
      carry are testable (corruption -> CRC -> retry) without a second
      host.

    ``delta_shipping=True`` exchanges chain digests with the destination
    before exporting and skips every leading full block its prefix cache
    already holds — those blocks cross as digest references
    (``acquire_known`` re-pins them at bind time), not page bytes.

    The latency recorded spans the whole protocol including the copy (the
    destination's stream is synchronized before the clock stops — the
    handoff IS the disaggregation tax being measured). ``bytes_shipped``
    counts the exported pages' device bytes (the source pool's dtype);
    ``wire_bytes_shipped`` counts bytes on a
    link — the serialized frame length on the wire codec, per-page
    data+scale bytes on the device codec — and is what ``record_handoff``
    reports per request."""

    def __init__(self, retries=2, retry_delay_s=0.01, rng=None, sleep=None,
                 codec="device", delta_shipping=False, wire_quantize=True):
        if codec not in ("device", "wire"):
            raise ValueError(f"unknown transport codec {codec!r}; "
                             f"expected 'device' or 'wire'")
        self.codec = codec
        self.delta_shipping = bool(delta_shipping)
        self._wire_quantize = bool(wire_quantize)
        self.handoffs = 0
        self.transfers = 0
        self.pages_shipped = 0
        self.pages_bound = 0
        self.bytes_shipped = 0
        self.wire_bytes_shipped = 0
        self.wire_bytes_saved = 0     # delta-shipping: bytes NOT sent
        self.pages_delta_skipped = 0
        self.crc_failures = 0         # wire frames rejected by a page CRC
        self.total_s = 0.0
        self.retry_trips = 0
        self.failed_handoffs = 0
        # transient-failure hardening: each retryable unit is wrapped in
        # utils/retry.retry_call (rng/sleep injectable so drills pin exact
        # schedules). Two units with different retry semantics:
        #   export   — retries on the armed ``transport.drop`` fault only
        #              (fires BEFORE the export, pages still resident);
        #   wire leg — retries on WireCRCError (``transport.corrupt``
        #              flips a payload byte; the CRC32 check catches it and
        #              the frame re-serializes from the landed export).
        self._retries = int(retries)
        self._retry_delay_s = float(retry_delay_s)
        self._rng = rng
        self._sleep = sleep if sleep is not None else time.sleep

    def ship(self, uid, src_engine, dst_engine, src="prefill", dst="decode"):
        """Move ``uid``'s pages from ``src_engine`` to ``dst_engine``;
        returns the number of pages bound at the destination."""
        return self.ship_many([uid], src_engine, dst_engine,
                              src=src, dst=dst)

    def page_wire_cost(self, engine):
        """Wire bytes ONE page (a block row, K+V, all layers) costs from
        ``engine``'s pool — pure host-side shape math, no device touch.
        The flow-control admission unit and the delta-shipping savings
        ledger. int8 pools and the wire-quantized fp leg both put one int8
        per element plus one fp32 scale per token row on the wire."""
        kc = engine._state.kv_cache
        L, _, H, bs, hd = kc.k_pool.shape
        if kc.quantized or (self.codec == "wire" and self._wire_quantize):
            return 2 * L * H * bs * (hd + 4)
        return 2 * L * H * bs * hd * kc.k_pool.element_size()

    def _delta_skip(self, uids, src_engine, dst_engine):
        """The digest exchange: {uid: leading full blocks the destination
        already holds} (None when delta-shipping is off or nothing
        matches). Advisory — the destination may evict between this answer
        and the bind, so ``import_sequences_pages`` re-resolves and a
        shortfall surfaces as a bind-stage HandoffError (re-prefill)."""
        if not self.delta_shipping:
            return None
        chains = src_engine.sequence_block_digests(uids)
        chains = {u: c for u, c in chains.items() if c}
        if not chains:
            return None
        held = dst_engine.held_prefix_lens(chains)
        skip = {u: n for u, n in held.items() if n}
        return skip or None

    def _export(self, uids, src_engine, skip, detail):
        """The pre-export retryable unit. ``transport.drop`` fires BEFORE
        the export, so a retried attempt still finds the source pages
        resident — past the export the source allocator has released them
        and a retry could never reproduce the data."""
        faults.maybe_fail("transport.drop", detail)
        with on_device(src_engine.device):
            if skip:
                return src_engine.export_pages_many(uids, skip=skip)
            return src_engine.export_pages_many(uids)

    def _device_leg(self, handle, dst_engine):
        """In-process codec: one copy of the exported page rows (``(data,
        scale)`` pairs for int8 pools) to the destination pool's device."""
        dev = dst_engine.kv_page_device
        with on_device(dev):
            handle["k"] = pages_to(handle["k"], dev)
            handle["v"] = pages_to(handle["v"], dev)

    def _wire_leg(self, handle, src_engine, dst_engine, detail):
        """One wire-codec attempt (the post-export retryable unit):
        serialize the exported handle, run the injected-corruption fault,
        CRC-verify + parse, and land the pages on the destination's
        sharding. A WireCRCError re-enters HERE — the export stays intact
        in the handle, so the frame re-serializes; the export itself never
        re-runs. Returns (import handle, frame bytes on the wire)."""
        with on_device(src_engine.device):
            frame = wire.encode_handle(
                handle, fetch=getattr(src_engine, "host_fetch", None),
                wire_quantize=self._wire_quantize)
        try:
            faults.maybe_fail("transport.corrupt", detail)
        except InjectedFault:
            # the drill models the link flipping a bit in flight: corrupt
            # the frame and let the REAL detection path (per-page CRC32 in
            # decode_frame) catch it
            frame = wire.corrupt(frame)
        dev = dst_engine.kv_page_device
        try:
            with on_device(dev):
                out = wire.decode_frame(frame, dev)
        except WireCRCError:
            self.crc_failures += 1
            raise
        return out, len(frame)

    def ship_many(self, uids, src_engine, dst_engine, src="prefill",
                  dst="decode"):
        """Move several finished sequences' pages in ONE gather ->
        transport leg -> scatter. The fleet batches every handoff that
        finished in the same scheduler round into one transfer, so the
        dispatch cost is per ROUND, not per request. ``handoffs`` counts
        requests, ``transfers`` counts device copies; the transfer latency
        is apportioned to each request's telemetry lane by its page share.
        Returns the total pages bound at the destination. Raises
        :class:`HandoffError` when any leg exhausts its retries (or hits a
        deterministic reject: version skew, delta bind miss) — the fleet
        catches it and re-prefills the requests on the decode side."""
        uids = list(uids)
        detail = f"{src}->{dst}"
        t0 = time.perf_counter()
        skip = self._delta_skip(uids, src_engine, dst_engine)
        try:
            handle = retry_call(
                self._export, uids, src_engine, skip, detail,
                retries=self._retries, base_delay=self._retry_delay_s,
                retry_on=(InjectedFault,), rng=self._rng, sleep=self._sleep,
                on_retry=lambda a, e, d: self._count_retry())
        except RetryError as e:
            self.failed_handoffs += len(uids)
            raise HandoffError(uids, "transfer", str(e)) from e
        # the device footprint of the exported pages (the wire leg hands the
        # destination dequantized fp32 pages, which are not what was shipped)
        nbytes = _nbytes(handle["k"], handle["v"])
        wire_nbytes = None
        try:
            if self.codec == "wire":
                handle, wire_nbytes = retry_call(
                    self._wire_leg, handle, src_engine, dst_engine, detail,
                    retries=self._retries, base_delay=self._retry_delay_s,
                    retry_on=(WireCRCError,), rng=self._rng,
                    sleep=self._sleep,
                    on_retry=lambda a, e, d: self._count_retry())
            else:
                self._device_leg(handle, dst_engine)
        except (RetryError, WireVersionError) as e:
            # past the export the source pages are gone either way — the
            # fallback re-prefills (it must NOT try to flush the source)
            self.failed_handoffs += len(uids)
            raise HandoffError(uids, "transfer", str(e)) from e
        if wire_nbytes is None:
            # device codec: the bytes a wire ship WOULD cost — per-page
            # data+scale bytes of the shipped rows
            wire_nbytes = wire.page_wire_nbytes(handle["k"], handle["v"]) \
                * int(handle["n"])
        try:
            faults.maybe_fail("handoff.bind_fail", detail)
            with on_device(dst_engine.device):
                bound = dst_engine.import_pages_many(handle)
        except (InjectedFault, ValueError) as e:
            # ValueError: delta bind miss — the destination evicted a
            # digest between the exchange and the bind (all-or-nothing
            # import rolled back)
            self.failed_handoffs += len(uids)
            raise HandoffError(uids, "bind", str(e)) from e
        # the latency covers the copies and the bind's scatter
        _settle(dst_engine.device)
        dt = time.perf_counter() - t0
        skipped = sum(int(m.get("skipped", 0)) for m in handle["seqs"])
        self.handoffs += len(uids)
        self.transfers += 1
        self.pages_shipped += handle["n"]
        self.pages_bound += bound
        self.bytes_shipped += nbytes
        self.wire_bytes_shipped += int(wire_nbytes)
        if skipped:
            self.pages_delta_skipped += skipped
            self.wire_bytes_saved += skipped * self.page_wire_cost(src_engine)
        self.total_s += dt
        tm = telemetry.get_telemetry()
        if tm.enabled and self.wire_bytes_saved:
            tm.record("fleet/wire_bytes_saved", self.wire_bytes_saved,
                      kind="gauge")
        total = max(handle["n"], 1)
        for m in handle["seqs"]:
            share = m["n"] / total
            telemetry.record_handoff(m["uid"], m["n"],
                                     int(nbytes * share), dt * share,
                                     src=src, dst=dst, bound=m["n"],
                                     wire_nbytes=int(wire_nbytes * share))
        return bound

    def _count_retry(self):
        self.retry_trips += 1
        tm = telemetry.get_telemetry()
        if tm.enabled:
            tm.fleet_event("handoff_retry")

    def stats(self):
        return {"handoffs": self.handoffs,
                "transfers": self.transfers,
                "codec": self.codec,
                "delta_shipping": self.delta_shipping,
                "pages_shipped": self.pages_shipped,
                "pages_bound": self.pages_bound,
                "pages_delta_skipped": self.pages_delta_skipped,
                "bytes_shipped": self.bytes_shipped,
                "wire_bytes_shipped": self.wire_bytes_shipped,
                "wire_bytes_saved": self.wire_bytes_saved,
                "crc_failures": self.crc_failures,
                "retry_trips": self.retry_trips,
                "failed_handoffs": self.failed_handoffs,
                "total_s": self.total_s}


class FlowControl:
    """Per-(src, dst) in-flight wire-byte budget with router-visible
    backpressure.

    The in-process fleet ships synchronously, so "in flight" is scoped to
    one scheduler round: ``open_round`` clears the ledger at the top of
    ``_flush_handoffs`` (last round's ships have all landed by then),
    ``admit`` reserves a link's bytes, and a group that would oversubscribe
    its link DEFERS to the next round (the fleet re-queues it) instead of
    stalling the step. A group arriving at an empty link window always
    admits even when larger than the budget — a mega-handoff must still
    ship, just alone on its link.

    Deferred bytes are the backpressure signal: ``backpressure_s(src)``
    converts a source's queued backlog into seconds at the modeled link
    bandwidth, and the SLO router adds that to its TTFT prediction for the
    replica (``link_backpressure_s``) — an oversubscribed link queues
    *visibly* instead of silently blowing admission estimates."""

    def __init__(self, max_inflight_bytes=64 << 20, link_gbps=25.0):
        self.max_inflight_bytes = int(max_inflight_bytes)
        self._link_bytes_per_s = float(link_gbps) * 1e9 / 8
        self._inflight = {}   # (src, dst) -> bytes reserved this round
        self._queued = {}     # src -> bytes deferred past this round
        self.deferrals = 0
        self.peak_inflight_bytes = 0

    def open_round(self):
        """Start a fresh round window; deferred groups re-admit first (the
        fleet keeps them at the head of its pending list)."""
        self._inflight.clear()
        self._queued.clear()

    def admit(self, src, dst, nbytes):
        """Reserve ``nbytes`` on the (src, dst) link; False = defer (the
        reservation is recorded as queued backlog instead)."""
        nbytes = int(nbytes)
        cur = self._inflight.get((src, dst), 0)
        if cur and cur + nbytes > self.max_inflight_bytes:
            self._queued[src] = self._queued.get(src, 0) + nbytes
            self.deferrals += 1
            return False
        self._inflight[(src, dst)] = cur + nbytes
        self.peak_inflight_bytes = max(self.peak_inflight_bytes,
                                       self.inflight_bytes())
        return True

    def inflight_bytes(self):
        return sum(self._inflight.values())

    def queued_bytes(self, src=None):
        if src is None:
            return sum(self._queued.values())
        return self._queued.get(src, 0)

    def backpressure_s(self, src=None):
        """Seconds of queued handoff backlog at the modeled link
        bandwidth — the TTFT term the SLO router folds in."""
        return self.queued_bytes(src) / self._link_bytes_per_s

    def stats(self):
        return {"max_inflight_bytes": self.max_inflight_bytes,
                "inflight_bytes": self.inflight_bytes(),
                "queued_bytes": self.queued_bytes(),
                "deferrals": self.deferrals,
                "peak_inflight_bytes": self.peak_inflight_bytes}


class PrefillDecodeFleet:
    """Prefill-specialized + decode-specialized replicas over one device set.

    Args:
        model: the model every replica serves (``ReplicaGroup``: replicas
            on its device share its weights, others get a copy).
        prefill_replicas / decode_replicas: replica counts per side.
        devices: one torch device per replica, prefill side first, then
            decode; devices past those are spares the autoscaler raises new
            decode replicas on. Several replicas may share a device.
            Default: every replica on the current CUDA device.
        tp_size: devices per replica; only 1 is ported (A5 part 3).
        engine_config / token_budget: prefill-side engine config + SplitFuse
            budget (prefill wants a LARGE budget — it only sees chunks).
        decode_engine_config / decode_token_budget: decode-side overrides
            (default: same config; budget defaults to the decode batch size
            need, which is just the concurrent-sequence count). Size the
            decode pool for the working set of in-flight sequences — a
            handoff that cannot bind anywhere falls back to re-prefill on
            the decode side (bit-exact, but the prefill compute is paid
            twice; ``handoff_fallbacks`` counts these). Decode replicas
            built from a dict/None config default ``speculative.enabled``
            ON when the model has a verify forward (bit-exact either way,
            test-pinned); pass an explicit ``speculative`` key or a config
            OBJECT to override, or ``speculative_default=False`` to keep
            plain decode.
        transport: a configured :class:`KVPageTransport`; default builds
            one from ``codec`` / ``delta_shipping``.
        codec / delta_shipping: transport construction shorthand — the
            serialized wire leg and the digest-exchange delta ship (see
            :class:`KVPageTransport`).
        flow: a :class:`FlowControl` bounding per-(src, dst) in-flight
            handoff bytes; over-budget groups defer a round and surface as
            ``link_backpressure_s`` in the SLO router's TTFT prediction.
            None = unbounded (every handoff ships the round it finishes).
        heartbeat_timeout_s: failure-detector window — a replica that
            completes no step for this long is declared dead and its
            in-flight requests re-admit elsewhere.
    """

    def __init__(self, model, prefill_replicas=1, decode_replicas=1,
                 devices=None, tp_size=1, engine_config=None, token_budget=None,
                 decode_engine_config=None, decode_token_budget=None,
                 transport=None, codec="device", delta_shipping=False,
                 flow=None, speculative_default=True,
                 heartbeat_timeout_s=30.0):
        check_single_rank(tp_size)
        need = prefill_replicas + decode_replicas
        devices = ["cuda"] * need if devices is None else list(devices)
        if need > len(devices):
            raise ValueError(
                f"fleet needs {need} devices ({prefill_replicas} prefill + "
                f"{decode_replicas} decode); {len(devices)} given")
        self.lifecycle = lc.ReplicaLifecycle()
        self.detector = lc.FailureDetector(timeout_s=heartbeat_timeout_s)
        self._models = _ModelCopies(model)
        self.prefill = []
        for i in range(prefill_replicas):
            dev, sched = build_device_replica(self._models, devices[i],
                                              engine_config, token_budget)
            sched.on_finish = functools.partial(self._on_prefill_finish, i)
            self.prefill.append((dev, sched))
            self.lifecycle.add(("prefill", i))
        decode_cfg = decode_engine_config or engine_config
        if speculative_default:
            decode_cfg = self._with_speculative_default(decode_cfg, model)
        self.decode = []
        for j in range(decode_replicas):
            self.decode.append(build_device_replica(
                self._models, devices[prefill_replicas + j], decode_cfg,
                decode_token_budget or token_budget))
            self.lifecycle.add(("decode", j))
        self.transport = transport or KVPageTransport(
            codec=codec, delta_shipping=delta_shipping)
        self.flow = flow
        self._meta = {}   # uid -> decode-leg params (limits, sampling, seed)
        self._route = {}  # uid -> ("prefill" | "decode" | "done", index)
        self._pending_ships = []  # (prefill index, request) awaiting handoff
        # elasticity state: the builder args are kept so the autoscaler can
        # raise new decode replicas on spare devices; retired engines park
        # in the warm pool and revive (at a NEW lifecycle key) with their
        # pools already allocated
        self._decode_cfg = decode_cfg
        self._decode_budget = decode_token_budget or token_budget
        self._devices = devices
        self._next_device = need
        self._warm_decode = []       # retired (device, sched) pairs, reusable
        self._census_exempt = set()  # fault-dead keys: pages died with them
        self._readmit_prefix = {}    # uid -> tokens emitted before readmit
        self._readmit_owner = {}     # uid -> (role, index) holding the tail
        self._recovered_done = {}    # uid -> full output (done at recovery)
        self._recovered_finished = []  # uids to surface as finished
        self._terminal = []  # fleet-level (uid, outcome) beyond the scheds
        self._step_no = 0
        # always-on elasticity counters (readable with telemetry off)
        self.replica_losses = 0
        self.readmitted = 0
        self.handoff_fallbacks = 0
        self.scale_ups = 0
        self.scale_downs = 0
        logger.info(f"PrefillDecodeFleet: {prefill_replicas} prefill + "
                    f"{decode_replicas} decode replicas on "
                    f"{[str(d) for d, _ in self.prefill + self.decode]}")

    @staticmethod
    def _with_speculative_default(cfg, model):
        """Decode replicas speculate by default: the fleet's decode side is
        pure decode rows, exactly where draft-then-verify pays, and
        generation is bit-exact either way (test-pinned through the
        handoff). Only dict/None configs are touched — an explicit config
        OBJECT is the operator's word — an explicit ``speculative`` key
        always wins, and models without a verify forward (Mixtral/Falcon/
        Phi/OPT) keep plain decode."""
        if not (cfg is None or isinstance(cfg, dict)):
            return cfg
        if cfg and "speculative" in cfg:
            return cfg
        from deepspeed_tpu_torch.inference.v2.engine_factory import \
            resolve_verify_fn
        if resolve_verify_fn(model) is None:
            return cfg
        out = dict(cfg or {})
        out["speculative"] = {"enabled": True}
        return out

    # -- routing surface (SLORouter backend protocol) ----------------------
    def router_targets(self):
        """Placement targets for ``SLORouter`` — the prefill side only;
        decode placement happens at handoff (least KV occupancy)."""
        return list(self.prefill)

    @property
    def has_work(self):
        # dead replicas are excluded: their host tables still show the
        # in-flight requests they lost (kept readable for recovery), and
        # counting those would wedge run_to_completion forever
        for role, side in (("prefill", self.prefill),
                           ("decode", self.decode)):
            for i, (_, sched) in enumerate(side):
                if self.lifecycle.is_stepping((role, i)) and sched.has_work:
                    return True
        return bool(self._pending_ships) or bool(self._recovered_finished)

    def target_alive(self, i):
        """Router probe: prefill target ``i`` takes new placements only
        while LIVE (draining and dead targets are skipped)."""
        return self.lifecycle.is_live(("prefill", i))

    def submit(self, uid, prompt, max_new_tokens=16, eos_token_id=None,
               temperature=0.0, top_k=0, top_p=1.0, seed=None,
               replica=None, slo_class=None):
        """Admit a request on a prefill replica (least-active when
        ``replica`` is None). The prefill leg is capped at ONE generated
        token; the remaining ``max_new_tokens`` run on the decode side
        after the handoff. ``slo_class`` rides the whole hop chain — the
        adopting decode scheduler keeps tagging the request's samples."""
        if seed is None:
            # drawn HERE, not in the prefill scheduler: prefill and decode
            # must share one deterministic sampling stream for bit-exactness
            seed = secrets.randbits(31)
        if replica is None:
            live = [i for (_, i) in self.lifecycle.live("prefill")]
            if not live:
                raise RuntimeError("no live prefill replica to admit onto")
            replica = min(live,
                          key=lambda i: self.prefill[i][1].active_count())
        elif not self.lifecycle.is_live(("prefill", replica)):
            raise ValueError(f"prefill replica {replica} is "
                             f"{self.lifecycle.state(('prefill', replica))}")
        self._meta[uid] = {"max_new_tokens": int(max_new_tokens),
                           "eos_token_id": eos_token_id,
                           "temperature": float(temperature),
                           "top_k": int(top_k), "top_p": float(top_p),
                           "seed": int(seed)}
        self._route[uid] = ("prefill", replica)
        dev, sched = self.prefill[replica]
        with on_device(dev):
            sched.submit(uid, prompt, max_new_tokens=1,
                         eos_token_id=eos_token_id, temperature=temperature,
                         top_k=top_k, top_p=top_p, seed=seed,
                         slo_class=slo_class)
        return replica

    def warm_transport(self, max_pages=None):
        """Run every (prefill -> decode) page-transfer path once before the
        serving clock starts (``InferenceEngineV2.warm_page_transfer``: the
        first peer copy between two cards), at up to a full batched round
        of handoffs — every prefill that can finish in one round (the
        scheduler's sequence cap) at the maximum per-sequence page count."""
        for pdev, psched in self.prefill:
            per_seq = -(-psched.max_context // psched.engine.kv_block_size)
            smax = psched.engine._config.state_manager \
                .max_ragged_sequence_count
            pages = max_pages or per_seq * smax
            for _, dsched in self.decode:
                with on_device(pdev):
                    psched.engine.warm_page_transfer(dsched.engine, pages)

    # -- handoff -----------------------------------------------------------
    def _pick_decode(self, need_blocks):
        """Least-KV-occupancy LIVE decode replica that can bind
        ``need_blocks`` pages (``free_blocks`` counts evictable cached
        blocks — the allocator evicts parked pages before declaring
        exhaustion). Draining and dead replicas never take new work."""
        order = sorted(
            self.live_decode_indices(),
            key=lambda j: self.decode[j][1].kv_stats()["occupancy"])
        for j in order:
            if self.decode[j][1].engine.free_blocks >= need_blocks:
                return j
        return None

    def _on_prefill_finish(self, index, sched, req):
        """``SplitFuseScheduler.on_finish`` hook on prefill replica
        ``index``: defer the ship-and-adopt unless the request is truly
        complete. Returns True when ownership will move (the prefill side
        then skips flush + terminal telemetry; the sequence's pages stay
        resident until ``_flush_handoffs`` exports them at the end of the
        round, so every handoff that finishes in one round shares ONE
        device transfer instead of paying a dispatch each)."""
        meta = self._meta.get(req.uid)
        if meta is None:
            return False  # not fleet-managed (defensive)
        tok = req.generated[-1]
        # pos_offset covers requests re-admitted ONTO a prefill replica
        # (last-resort recovery): their local token count is a tail of the
        # stream, so completion compares the stream total
        if len(req.generated) + req.pos_offset >= meta["max_new_tokens"] or \
                (meta["eos_token_id"] is not None and
                 tok == meta["eos_token_id"]):
            # wanted exactly one token, or EOS on the first: complete at
            # prefill — normal flush + finish events apply
            self._route[req.uid] = ("done", index)
            return False
        self._pending_ships.append((index, req))
        return True

    def _flush_handoffs(self):
        """Ship every request that finished prefill this round. Handoffs
        are grouped per source replica into one ``ship_many`` transfer
        when a single decode pool can bind the whole group; otherwise the
        group falls back to per-request placement (spreading across
        pools). A request that cannot bind anywhere — pools exhausted, or
        the transfer/bind itself failed past retries — falls back to
        re-prefill on the decode side (``_handoff_fallback``) instead of
        raising through ``fleet.step()``. With flow control, a group that
        would oversubscribe its (src, dst) link's in-flight byte budget
        DEFERS to the next round (re-queued at the head of
        ``_pending_ships``) — the deferred bytes surface to the SLO router
        as ``link_backpressure_s``."""
        if self.flow is not None:
            self.flow.open_round()
        if not self._pending_ships:
            return
        pending, self._pending_ships = self._pending_ships, []
        by_src = {}
        for index, req in pending:
            by_src.setdefault(index, []).append(req)
        for index, reqs in by_src.items():
            block = self.prefill[index][1].engine.kv_block_size
            pages = [-(-len(r.prompt) // block) for r in reqs]
            j = self._pick_decode(sum(pages))
            if j is not None:
                if not self._flow_admit(index, j, sum(pages)):
                    self._pending_ships.extend((index, r) for r in reqs)
                    continue
                self._ship_group(index, reqs, j)
                continue
            for req, need in zip(reqs, pages):
                j = self._pick_decode(need)
                if j is None:
                    logger.warning(
                        f"fleet: no decode replica can bind {need} KV "
                        f"pages for uid {req.uid}; falling back to "
                        f"re-prefill on the decode side")
                    self._handoff_fallback(index, req, "bind_capacity")
                    continue
                if not self._flow_admit(index, j, need):
                    self._pending_ships.append((index, req))
                    continue
                self._ship_group(index, [req], j)
        if self.flow is not None:
            tm = telemetry.get_telemetry()
            if tm.enabled:
                tm.record("fleet/inflight_bytes",
                          self.flow.inflight_bytes(), kind="gauge")

    def _flow_admit(self, index, j, need_pages):
        """Reserve a group's estimated wire bytes on the prefill[index] ->
        decode[j] link (always True without flow control). The estimate is
        pool-shape math, pre-delta — conservative: a delta-shipped group
        uses less of the window than it reserved."""
        if self.flow is None:
            return True
        est = need_pages * self.transport.page_wire_cost(
            self.prefill[index][1].engine)
        return self.flow.admit(f"prefill{index}", f"decode{j}", est)

    def link_backpressure_s(self, index):
        """Seconds of deferred handoff backlog queued on prefill
        ``index``'s outbound links — the flow-control term the SLO router
        adds to its TTFT prediction for that replica. 0.0 without flow
        control (nothing ever queues)."""
        if self.flow is None:
            return 0.0
        return self.flow.backpressure_s(f"prefill{index}")

    def _ship_group(self, index, reqs, j):
        """One transfer prefill[index] -> decode[j] covering ``reqs``,
        then adopt each on the decode scheduler. A :class:`HandoffError`
        (transfer retries exhausted / bind failed) downgrades every request
        in the group to the re-prefill fallback."""
        _, psched = self.prefill[index]
        ddev, dsched = self.decode[j]
        try:
            self.transport.ship_many(
                [r.uid for r in reqs], psched.engine, dsched.engine,
                src=f"prefill{index}", dst=f"decode{j}")
        except HandoffError as e:
            logger.warning(f"fleet: {e}; re-prefilling on the decode side")
            for req in reqs:
                self._handoff_fallback(index, req, e.stage)
            return
        with on_device(ddev):
            for req in reqs:
                meta = self._meta[req.uid]
                dsched.adopt(req.uid, req.prompt, req.generated,
                             max_new_tokens=meta["max_new_tokens"],
                             eos_token_id=meta["eos_token_id"],
                             temperature=meta["temperature"],
                             top_k=meta["top_k"], top_p=meta["top_p"],
                             seed=meta["seed"], submit_ts=req.submit_ts,
                             last_token_ts=req.last_token_ts,
                             slo_class=req.slo_class)
        for req in reqs:
            self._route[req.uid] = ("decode", j)
            self._readmit_owner[req.uid] = ("decode", j)

    def _handoff_fallback(self, index, req, stage):
        """A handoff that cannot complete re-prefills on the decode side:
        flush the source pages if they are still resident (a transfer-stage
        failure leaves them; a bind-stage failure already released them
        with the export), then re-admit — same seed, same stream position,
        so the output stays bit-exact; only the prefill compute is paid
        again."""
        pdev, psched = self.prefill[index]
        if psched.engine._state.get_sequence(req.uid) is not None:
            with on_device(pdev):
                psched.engine.flush(req.uid)
        self.handoff_fallbacks += 1
        tm = telemetry.get_telemetry()
        if tm.enabled:
            tm.fleet_event("handoff_fallback", stage=stage)
        self._readmit_request(req.uid, req, cause=f"handoff_{stage}")

    # -- serving loop ------------------------------------------------------
    def step(self):
        """One pipelined round: every stepping replica (both sides)
        launches its forward before any result is fetched, so one
        replica's host work overlaps the others' device work. Prefill completions collect during
        ``step_finish`` (the on_finish hook) and ship as ONE batched
        transfer per (source, destination) pair at the end of the round;
        the adopted requests decode next round. Returns uids that truly
        finished (handed-off uids are not reported by the prefill side).

        Fault points per replica per round, in order: ``replica.stall``
        (the replica skips the round WITHOUT heartbeating — the failure
        detector declares it dead once overdue) and ``replica.lost`` (the
        replica dies immediately — marked DEAD, routed around, its
        in-flight requests re-admitted from their last committed output)."""
        self._step_no += 1
        faults.set_step(self._step_no)
        pendings = []
        for role, side in (("prefill", self.prefill),
                           ("decode", self.decode)):
            for i, (dev, sched) in enumerate(side):
                key = (role, i)
                if not self.lifecycle.is_stepping(key):
                    continue
                try:
                    faults.maybe_fail("replica.stall", f"{role}{i}")
                    faults.maybe_fail("replica.lost", f"{role}{i}")
                except InjectedFault as e:
                    if e.point == "replica.lost":
                        self._lose_replica(role, i, cause="replica.lost")
                    # stall: wedged — skips the round and does NOT beat,
                    # so the detector eventually declares it dead
                    continue
                self.detector.beat(key)
                if not sched.has_work:
                    continue
                with on_device(dev):
                    p = sched.step_begin()
                if p is not None:
                    pendings.append((key, dev, sched, p))
        finished = []
        for key, dev, sched, p in pendings:
            if not self.lifecycle.is_stepping(key):
                continue  # died between launch and fetch this round
            with on_device(dev):
                finished.extend(sched.step_finish(p))
        # finished routes update BEFORE loss recovery, so a replica that
        # completes requests and then misses its heartbeat never re-admits
        # work it already reported
        for uid in finished:
            cur = self._route.get(uid)
            if cur is not None:
                self._route[uid] = ("done", cur[1])
        for key in self.detector.check():
            if self.lifecycle.is_stepping(key):
                self._lose_replica(*key, cause="missed_heartbeat")
        self._flush_handoffs()
        # planned drains retire once their last in-flight request finishes
        for j in range(len(self.decode)):
            key = ("decode", j)
            if self.lifecycle.state(key) == lc.DRAINING and \
                    self.decode[j][1].active_count() == 0:
                self._retire_decode(j)
        finished.extend(self._drain_recovered())
        return finished

    # -- replica loss recovery ---------------------------------------------
    def _lose_replica(self, role, index, cause):
        """Declare ``(role, index)`` dead and re-admit every request it
        held. The replica's host-side tables stay readable — the requests'
        committed tokens are the recovery state; only the KV pages died
        with the replica (re-prefill rebuilds them, and with prefix
        caching only the tail past the last committed digest runs)."""
        key = (role, index)
        if self.lifecycle.state(key) == lc.DEAD:
            return
        self.lifecycle.mark_dead(key)
        self.detector.forget(key)
        self.replica_losses += 1
        # its pool died with it — the page census must not read tombstones
        self._census_exempt.add(key)
        logger.warning(f"fleet: {role}{index} lost ({cause}); "
                       f"re-admitting its in-flight requests")
        tm = telemetry.get_telemetry()
        if tm.enabled:
            tm.fleet_event("replica_lost", replica=f"{role}{index}",
                           cause=cause)
        if role == "prefill":
            # pending ships from the dead source are stranded (pages gone);
            # their requests re-admit via the route scan below
            self._pending_ships = [(i, r) for (i, r) in self._pending_ships
                                   if i != index]
        side = self.prefill if role == "prefill" else self.decode
        sched = side[index][1]
        for uid, route in list(self._route.items()):
            if route != (role, index):
                continue
            req = sched._requests.get(uid)
            if req is None:
                continue
            if role == "decode" and req.done:
                continue  # finished and already reported (defensive)
            self._readmit_request(uid, req, cause=cause)

    def _readmit_request(self, uid, req, cause):
        """Re-admit a request whose KV pages are gone (replica loss,
        exhausted handoff, planned drain). Recovery state is the host-side
        committed output: ``_readmit_prefix`` (tokens emitted before any
        EARLIER re-admission) plus ``req.generated``. The stream resumes at
        the same (seed, position), so recovery is bit-exact. Placement:
        least-occupied live decode replica; live prefill as last resort;
        with neither, the request is terminally lost (fleet-level terminal
        event so the router still retires its backlog)."""
        meta = self._meta.get(uid)
        if meta is None:
            return  # not fleet-managed (defensive)
        tm = telemetry.get_telemetry()
        prefix = self._readmit_prefix.get(uid, ())
        prompt = req.prompt if not len(prefix) \
            else req.prompt[:len(req.prompt) - len(prefix)]
        full = list(prefix) + [int(t) for t in req.generated]
        if not full:
            # lost mid-prefill, nothing committed: re-run the prefill leg
            live = self.live_prefill_indices()
            if not live:
                self._lost_terminally(uid, cause)
                return
            target = min(live,
                         key=lambda i: self.prefill[i][1].active_count())
            dev, sched = self.prefill[target]
            with on_device(dev):
                sched.submit(uid, prompt, max_new_tokens=1,
                             eos_token_id=meta["eos_token_id"],
                             temperature=meta["temperature"],
                             top_k=meta["top_k"], top_p=meta["top_p"],
                             seed=meta["seed"], slo_class=req.slo_class)
            self._route[uid] = ("prefill", target)
        elif len(full) >= meta["max_new_tokens"] or \
                (meta["eos_token_id"] is not None and
                 full[-1] == meta["eos_token_id"]):
            # the stream was already complete in host state — surface it
            # as finished without touching any device
            self._recovered_done[uid] = np.asarray(full, np.int32)
            self._recovered_finished.append(uid)
            self._route[uid] = ("done", -1)
        else:
            live = self.live_decode_indices()
            if live:
                role = "decode"
                target = min(live, key=lambda j:
                             self.decode[j][1].kv_stats()["occupancy"])
                side = self.decode
            else:
                plive = self.live_prefill_indices()
                if not plive:
                    self._lost_terminally(uid, cause)
                    return
                role = "prefill"
                target = min(plive,
                             key=lambda i: self.prefill[i][1].active_count())
                side = self.prefill
            dev, sched = side[target]
            with on_device(dev):
                sched.readmit(uid, prompt, full,
                              max_new_tokens=meta["max_new_tokens"],
                              eos_token_id=meta["eos_token_id"],
                              temperature=meta["temperature"],
                              top_k=meta["top_k"], top_p=meta["top_p"],
                              seed=meta["seed"], submit_ts=req.submit_ts,
                              last_token_ts=req.last_token_ts,
                              slo_class=req.slo_class)
            self._readmit_prefix[uid] = full[:-1]
            self._readmit_owner[uid] = (role, target)
            self._route[uid] = (role, target)
        self.readmitted += 1
        if tm.enabled:
            tm.fleet_event("readmitted", cause=cause)

    def _lost_terminally(self, uid, cause):
        """No live replica can take the request: terminal loss. The
        fleet-level terminal event keeps the router's backlog accounting
        exact even in a total-outage drill."""
        logger.error(f"fleet: uid {uid} lost terminally ({cause}): "
                     f"no live replica to re-admit onto")
        self._terminal.append((uid, "lost"))
        self._route[uid] = ("done", -1)
        tm = telemetry.get_telemetry()
        if tm.enabled:
            tm.fleet_event("request_lost", cause=cause)

    def _drain_recovered(self):
        """Uids whose streams were already complete when recovered (no
        device round needed) — surfaced once through ``step()``'s finished
        list so the router retires them normally."""
        uids, self._recovered_finished = self._recovered_finished, []
        return uids

    # -- elasticity (autoscaler surface) -----------------------------------
    def live_prefill_indices(self):
        return [i for (_, i) in self.lifecycle.live("prefill")]

    def live_decode_indices(self):
        return [j for (_, j) in self.lifecycle.live("decode")]

    def decode_active(self, j):
        return self.decode[j][1].active_count()

    def decode_occupancy(self, j):
        return self.decode[j][1].kv_stats()["occupancy"]

    def live_replica_count(self):
        """Replicas still consuming devices (LIVE + DRAINING) — the
        denominator of goodput-per-replica-second."""
        c = self.lifecycle.counts()
        return c[lc.LIVE] + c[lc.DRAINING]

    def _spare_device(self):
        """The next device of the fleet's list never assigned to a replica
        (None when the list is exhausted — the autoscaler then keeps the
        current fleet)."""
        if self._next_device >= len(self._devices):
            return None
        self._next_device += 1
        return self._devices[self._next_device - 1]

    def scale_up_decode(self):
        """Raise one decode replica: warm pool first (a retired engine
        revives with its pool allocated), else a fresh build on a spare
        device. The replica joins at a NEW index/lifecycle key — dead keys
        never revive. Returns the new index, or None when no capacity
        exists."""
        if self._warm_decode:
            dev, sched = self._warm_decode.pop()
        else:
            dev = self._spare_device()
            if dev is None:
                return None
            dev, sched = build_device_replica(self._models, dev, self._decode_cfg,
                                              self._decode_budget)
        j = len(self.decode)
        self.decode.append((dev, sched))
        self.lifecycle.add(("decode", j))
        self.scale_ups += 1
        logger.info(f"fleet: scaled up decode{j}")
        tm = telemetry.get_telemetry()
        if tm.enabled:
            tm.fleet_event("scale_up", replica=f"decode{j}")
        return j

    def scale_down_decode(self, j, migrate=True):
        """Gracefully remove decode replica ``j``: mark DRAINING (no new
        placements), migrate its in-flight requests to the surviving fleet
        (cancel + bit-exact re-admission — the scale-down reuses the
        recovery path, so it is chaos-tested by construction), and retire
        the engine to the warm pool once idle. ``migrate=False`` lets the
        replica finish its work in place instead."""
        key = ("decode", j)
        if not self.lifecycle.is_live(key):
            raise ValueError(f"decode replica {j} is "
                             f"{self.lifecycle.state(key)}")
        self.lifecycle.mark_draining(key)
        self.scale_downs += 1
        logger.info(f"fleet: draining decode{j} for scale-down")
        tm = telemetry.get_telemetry()
        if tm.enabled:
            tm.fleet_event("scale_down", replica=f"decode{j}")
        if migrate:
            self._migrate_decode(j)
        if self.decode[j][1].active_count() == 0:
            self._retire_decode(j)

    def _migrate_decode(self, j):
        """Move every live request off decode ``j``: scheduler ``cancel``
        frees the pages (and appends a "cancelled" terminal event, which is
        popped — migration is NOT terminal; the router must keep the
        backlog), then the recovery path re-admits the stream elsewhere."""
        dev, sched = self.decode[j]
        for uid, route in list(self._route.items()):
            if route != ("decode", j):
                continue
            req = sched._requests.get(uid)
            if req is None or req.done:
                continue
            with on_device(dev):
                sched.cancel(uid)
            ev = sched.terminal_events.pop()
            assert ev == (uid, "cancelled"), ev
            self._readmit_request(uid, req, cause="drain")

    def _retire_decode(self, j):
        """Tombstone a drained decode replica and park its engine in the
        warm pool (the next scale-up reuses it, pool and all)."""
        key = ("decode", j)
        self.lifecycle.mark_dead(key)
        self.detector.forget(key)
        self._warm_decode.append(self.decode[j])
        logger.info(f"fleet: decode{j} retired to warm pool")

    def drain_terminal(self):
        """Terminal outcomes beyond plain finish since the last call, from
        every replica scheduler plus the fleet itself (terminally lost
        requests) — the router retires predicted backlog on these."""
        events, self._terminal = self._terminal, []
        seen = set()
        for side in (self.prefill, self.decode):
            for _, sched in side:
                if id(sched) in seen:  # warm-pool revival aliases an index
                    continue
                seen.add(id(sched))
                events.extend(sched.drain_terminal())
        return events

    def cancel(self, uid):
        """Cancel wherever the request currently lives; frees its KV pages
        on that side. Returns True iff it was live."""
        route = self._route.get(uid)
        if route is None:
            return False
        state, index = route
        side = {"prefill": self.prefill, "decode": self.decode}.get(state)
        if side is None:
            return False  # already done
        dev, sched = side[index]
        with on_device(dev):
            ok = sched.cancel(uid)
        if ok:
            self._route[uid] = ("done", index)
        return ok

    def results(self):
        """Merged {uid: generated tokens}; decode-side entries win (they
        extend the prefill side's first token). Re-admitted requests
        overlay as prefix-before-loss + current owner's tail, so a dead
        replica's stale partial output never wins; streams that were
        already complete at recovery come from ``_recovered_done``."""
        out = {}
        per = {}
        for role, side in (("prefill", self.prefill),
                           ("decode", self.decode)):
            for i, (_, sched) in enumerate(side):
                r = sched.results()
                per[(role, i)] = r
                out.update(r)
        for uid, prefix in self._readmit_prefix.items():
            owner = self._readmit_owner.get(uid)
            if owner is None:
                continue
            tail = per.get(owner, {}).get(uid)
            if tail is None:
                continue
            head = np.asarray(prefix, np.int32)
            tail = np.asarray(tail, np.int32)
            out[uid] = np.concatenate([head, tail]) if len(head) else tail
        out.update(self._recovered_done)
        return out

    def page_census(self):
        """Fleet-wide KV page accounting for leak drills: per-replica
        ``occupied_blocks`` (device blocks live under sequences) plus the
        ``leaked_pages`` total — occupied blocks on replicas with ZERO
        in-flight requests. Fault-dead replicas are exempt (their pool
        died with them); planned retirements are NOT — a drained replica
        must hand back every page."""
        per = []
        leaked = 0
        seen = set()
        for role, side in (("prefill", self.prefill),
                           ("decode", self.decode)):
            for i, (_, sched) in enumerate(side):
                if id(sched) in seen:  # warm-pool revival aliases an index
                    continue
                seen.add(id(sched))
                key = (role, i)
                if key in self._census_exempt:
                    continue
                st = sched.kv_stats()
                idle = sched.active_count() == 0
                per.append({"replica": f"{role}{i}",
                            "state": self.lifecycle.state(key),
                            "occupied_blocks": st["occupied_blocks"],
                            "active": sched.active_count()})
                if idle:
                    leaked += st["occupied_blocks"]
        return {"replicas": per, "leaked_pages": int(leaked)}

    def run_to_completion(self, max_rounds=10000):
        for _ in range(max_rounds):
            if not self.has_work:
                break
            self.step()
        else:
            raise RuntimeError("fleet did not converge")
        return self.results()

    def load_report(self):
        """Per-replica load by role + transport accounting.
        ``tokens_per_round`` is each replica's live accept-rate EWMA (1.0
        unless it speculates) — the signal the SLO router divides its
        backlog-rounds estimate by. A speculating decode side is just a
        ``decode_engine_config`` with ``speculative.enabled``; the configs
        flow through ``build_device_replica`` untouched."""
        per = []
        for role, side in (("prefill", self.prefill),
                           ("decode", self.decode)):
            for i, (dev, sched) in enumerate(side):
                per.append({"replica": f"{role}{i}", "role": role,
                            "device": str(dev),
                            "state": self.lifecycle.state((role, i)),
                            "active": sched.active_count(),
                            "tokens_per_round": sched.tokens_per_round(),
                            "kv_occupancy":
                                sched.kv_stats()["occupancy"]})
        rep = {"replicas": per, "transport": self.transport.stats(),
               "flow": self.flow.stats() if self.flow is not None else None,
               "lifecycle": self.lifecycle.counts(),
               "elasticity": {"replica_losses": self.replica_losses,
                              "readmitted": self.readmitted,
                              "handoff_fallbacks": self.handoff_fallbacks,
                              "scale_ups": self.scale_ups,
                              "scale_downs": self.scale_downs,
                              "warm_pool": len(self._warm_decode)}}
        slo = telemetry.slo_snapshot()
        if slo:
            rep["slo_classes"] = slo
        return rep

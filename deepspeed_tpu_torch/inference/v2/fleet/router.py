"""SLO-aware admission router over a replica backend (port of
``deepspeed_tpu/inference/v2/fleet/router.py``).

The reference scales FastGen with MII's replica load balancer; this is the
admission-control upgrade the ROADMAP calls for: instead of blind
round-robin, every request is placed on the replica with the LEAST
PREDICTED TTFT, computed from live serving telemetry (the ``serving/tpot_s``
histogram gives the fleet's measured per-step seconds), the router's own
outstanding-token backlog per replica, and KV occupancy. Requests whose
chain digest hits a replica's warm prefix cache are pulled toward it
(prefix-digest affinity — the cached blocks make its predicted TTFT
strictly smaller). Requests that cannot meet the SLO anywhere are QUEUED
(bounded) or REJECTED (shed) with typed outcomes, never silently admitted
into an unbounded backlog.

Backends: anything exposing ``router_targets() -> [(device, scheduler)]``,
``submit(uid, prompt, replica=i, **kw)``, ``step() -> finished uids`` and
``has_work`` — ``ReplicaGroup`` (dp replicas) and ``PrefillDecodeFleet``
(specialized prefill/decode sides) both qualify. Two optional probes make
the router elasticity-aware: ``target_alive(i)`` (dead/draining targets
are never placed on) and ``drain_terminal()`` (evict/cancel/replica-loss
outcomes retire from the backlog model exactly like finishes).
"""

import collections
import dataclasses
import math

import numpy as np

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.inference.v2.scheduler import sheddable_classes


@dataclasses.dataclass
class RequestAdmitted:
    """Placed on ``replica`` with ``predicted_ttft_s`` at admission;
    ``affinity_tokens`` > 0 means a warm prefix pulled it there."""
    uid: int
    replica: int
    predicted_ttft_s: float
    affinity_tokens: int = 0


@dataclasses.dataclass
class RequestQueued:
    """Over SLO on every replica but the bounded router queue has room;
    drained (FIFO) as capacity frees."""
    uid: int
    position: int
    predicted_ttft_s: float


@dataclasses.dataclass
class RequestRejected:
    """Shed: over SLO everywhere and the queue is full, or the request can
    never be served (e.g. prompt exceeds max_context)."""
    uid: int
    reason: str
    predicted_ttft_s: float = math.inf


class SLORouter:
    """Least-predicted-TTFT placement with bounded queueing and shedding.

    Args:
        backend: ``ReplicaGroup`` / ``PrefillDecodeFleet`` (see module doc).
        slo_ttft_s: admission bar — a request predicted to exceed this on
            every replica queues (or sheds when the queue is full).
        queue_limit: router-side queue bound (the shed threshold).
        default_step_s: per-forward seconds assumed until the live
            ``serving/tpot_s`` histogram has samples (or telemetry is off).
        occupancy_high / occupancy_penalty: a replica above the occupancy
            threshold multiplies its predicted TTFT — admissions there risk
            preemption/swap, which the token-backlog model can't see.
        prefix_affinity: subtract each replica's cached-prefix coverage
            (``peek_prefix``) from the prompt tokens it would owe.
    """

    def __init__(self, backend, slo_ttft_s=0.5, queue_limit=32,
                 default_step_s=0.02, occupancy_high=0.95,
                 occupancy_penalty=4.0, prefix_affinity=True):
        self._backend = backend
        self._targets = [sched for _, sched in backend.router_targets()]
        if not self._targets:
            raise ValueError("backend has no router targets")
        self._slo = float(slo_ttft_s)
        self._queue_limit = int(queue_limit)
        self._default_step_s = float(default_step_s)
        self._occ_high = float(occupancy_high)
        self._occ_penalty = float(occupancy_penalty)
        self._prefix_affinity = bool(prefix_affinity)
        self._queue = collections.deque()
        # outstanding tokens routed to each target and not yet finished —
        # the backlog term of the TTFT prediction, O(1) per submit/finish
        self._backlog = [0] * len(self._targets)
        self._placed = {}  # uid -> (target index, expected tokens)
        self.submitted = 0
        self.admitted = 0
        self.queued = 0
        self.rejected = 0
        self.affinity_hits = 0
        # terminal outcomes beyond plain finish retired from the backlog
        # model (evict/cancel/replica loss — satellite of the chaos drill:
        # EVERY terminal path must retire, or predictions creep pessimistic)
        self.terminal_retired = 0
        # sheds by SLO class (None key = untagged requests) — always-on
        # dict so bench payloads prove batch absorbed ALL shedding
        self.shed_by_class = {}

    # -- TTFT prediction ---------------------------------------------------
    def _step_seconds(self):
        """Fleet-wide measured seconds per scheduler round: live
        ``serving/tpot_s`` p50 when telemetry has samples, else the
        configured default."""
        tm = telemetry.get_telemetry()
        if tm.enabled:
            p = tm.hist_percentiles("serving/tpot_s", (0.5,))
            if p and p[0] > 0:
                return p[0]
        return self._default_step_s

    def predicted_ttft(self, index, prompt_len, affinity_tokens=0):
        """Predicted submit->first-token seconds on replica ``index``:
        rounds to burn through (backlog + this prompt - cached prefix) at
        the replica's per-round throughput, times the measured per-round
        seconds, amplified when its KV pool is near capacity.

        Per-round throughput is the token budget times the replica's live
        ``tokens_per_round`` accept-rate EWMA (1.0 without speculation): a
        speculating replica retires several backlog tokens per decode round,
        and modeling it at 1/round would systematically over-predict its
        TTFT and starve it of placements it can actually serve fastest."""
        t = self._targets[index]
        owed = self._backlog[index] + max(prompt_len - affinity_tokens, 1)
        tpr_fn = getattr(t, "tokens_per_round", None)
        tpr = max(1.0, float(tpr_fn())) if tpr_fn is not None else 1.0
        rounds = math.ceil(owed / (max(t.budget, 1) * tpr))
        ttft = rounds * self._step_seconds()
        if t.kv_stats()["occupancy"] >= self._occ_high:
            ttft *= self._occ_penalty
        # KV-fabric flow control: handoff bytes queued on this replica's
        # outbound links add wire seconds the backlog model can't see — an
        # oversubscribed link pushes placements elsewhere instead of
        # silently inflating TTFT after admission
        bp = getattr(self._backend, "link_backpressure_s", None)
        if bp is not None:
            ttft += bp(index)
        return ttft

    def _place(self, prompt):
        """(best index, predicted ttft, affinity tokens) — least predicted
        TTFT; at equal TTFT the warmer prefix wins (the prediction is
        round-granular, so a cached prefix that doesn't change the round
        count still saves real prefill compute), then active count. Dead
        and draining targets (``backend.target_alive``) are skipped; with
        NO live target the result is None and the caller sheds/queues."""
        alive = getattr(self._backend, "target_alive", None)
        best = None
        for i, t in enumerate(self._targets):
            if alive is not None and not alive(i):
                continue
            aff = t.peek_prefix(prompt) if self._prefix_affinity else 0
            ttft = self.predicted_ttft(i, len(prompt), aff)
            key = (ttft, -aff, t.active_count())
            if best is None or key < best[0]:
                best = (key, i, ttft, aff)
        if best is None:
            return None
        return best[1], best[2], best[3]

    def _burning_classes(self):
        """SLO classes whose live burn-rate gauge exceeds 1 (either
        metric) — the shed-precedence trigger. () with telemetry off."""
        tm = telemetry.get_telemetry()
        if not tm.enabled:
            return ()
        out = []
        for cls in tm.slo_class_targets():
            for metric in ("ttft", "tpot"):
                v = tm.gauge_value(f"slo/{cls}/{metric}_burn_rate")
                if v is not None and v > 1.0:
                    out.append(cls)
                    break
        return out

    # -- admission ---------------------------------------------------------
    def _reject(self, uid, slo_class, reason, ttft=math.inf):
        """One typed shed, with per-class accounting on EVERY rejection
        path (the chaos payload proves which class absorbed the shedding)."""
        self.rejected += 1
        self.shed_by_class[slo_class] = \
            self.shed_by_class.get(slo_class, 0) + 1
        tm = telemetry.get_telemetry()
        if tm.enabled:
            tm.fleet_event("rejected")
            tm.fleet_event("shed", slo_class=slo_class or "none")
            tm.fleet_gauge("fleet/shed_rate", self.shed_rate)
            tm.fleet_gauge(f"slo/shed_by_class/{slo_class or 'none'}",
                           self.shed_by_class[slo_class])
        return RequestRejected(uid, reason, ttft)

    def submit(self, uid, prompt, max_new_tokens=16, **kwargs):
        """Route one request. Returns a typed outcome: ``RequestAdmitted``
        (placed now), ``RequestQueued`` (bounded router queue) or
        ``RequestRejected`` (shed).

        Shed precedence: while any SLO class's burn-rate gauge exceeds 1,
        arrivals in classes with strictly LOOSER TTFT targets (and untagged
        arrivals) are shed immediately — the burning interactive class
        keeps the capacity; batch absorbs the shedding, never the
        reverse."""
        self.submitted += 1
        cls = kwargs.get("slo_class")
        prompt = np.asarray(prompt, np.int32)
        tm = telemetry.get_telemetry()
        max_ctx = min(t.max_context for t in self._targets)
        if len(prompt) >= max_ctx:
            # unservable anywhere: typed rejection instead of a ValueError
            # from deep inside a scheduler
            return self._reject(
                uid, cls, f"prompt of {len(prompt)} tokens cannot fit "
                          f"max_context {max_ctx}")
        burning = self._burning_classes()
        if burning and cls not in burning:
            shed = sheddable_classes(telemetry.slo_class_targets(), burning)
            if cls is None or cls in shed:
                return self._reject(
                    uid, cls, f"shed for SLO precedence: class "
                              f"{sorted(burning)} is burning and "
                              f"{cls or 'untagged'} yields first")
        placed = self._place(prompt)
        if placed is None:
            # no live placement target (total prefill outage): queue if
            # room — replicas may come back — else shed
            if len(self._queue) < self._queue_limit:
                self._queue.append((uid, prompt, max_new_tokens, kwargs))
                self.queued += 1
                if tm.enabled:
                    tm.fleet_event("queued")
                    tm.fleet_gauge("fleet/queue_depth", len(self._queue))
                return RequestQueued(uid, len(self._queue) - 1, math.inf)
            return self._reject(
                uid, cls, "no live replica to place on and router queue "
                          "full")
        i, ttft, aff = placed
        if tm.enabled:
            tm.record_hist("fleet/predicted_ttft_s", ttft)
        if ttft <= self._slo:
            return self._admit(uid, prompt, i, ttft, aff, max_new_tokens,
                               kwargs)
        if len(self._queue) < self._queue_limit:
            self._queue.append((uid, prompt, max_new_tokens, kwargs))
            self.queued += 1
            if tm.enabled:
                tm.fleet_event("queued")
                tm.fleet_gauge("fleet/queue_depth", len(self._queue))
            return RequestQueued(uid, len(self._queue) - 1, ttft)
        return self._reject(
            uid, cls, f"predicted TTFT {ttft:.3f}s over SLO "
                      f"{self._slo:.3f}s on every replica and router "
                      f"queue full", ttft)

    def _admit(self, uid, prompt, index, ttft, aff, max_new_tokens, kwargs):
        tm = telemetry.get_telemetry()
        if tm.enabled:
            # opens the request's cross-replica flow chain BEFORE the
            # backend submit, so admit -> prefill -> handoff -> decode ->
            # finish renders as one arrowed chain in the merged trace
            tm.record_request_flow(uid, "admit", replica=index)
        self._backend.submit(uid, prompt, replica=index,
                             max_new_tokens=max_new_tokens, **kwargs)
        expected = len(prompt) + int(max_new_tokens)
        self._backlog[index] += expected
        self._placed[uid] = (index, expected)
        self.admitted += 1
        if tm.enabled:
            tm.fleet_event("admitted")
            if aff:
                tm.fleet_event("affinity_hit")
        if aff:
            self.affinity_hits += 1
        return RequestAdmitted(uid, index, ttft, aff)

    def _drain_queue(self):
        """FIFO re-admission: the head re-places when some replica is back
        under SLO. An idle backend force-admits — with nothing running, the
        prediction model has no live samples to trust and waiting longer
        cannot help."""
        while self._queue:
            uid, prompt, max_new_tokens, kwargs = self._queue[0]
            placed = self._place(prompt)
            if placed is None:
                break  # total outage: hold the queue until a replica lives
            i, ttft, aff = placed
            if ttft > self._slo and self._backend.has_work:
                break
            self._queue.popleft()
            self._admit(uid, prompt, i, ttft, aff, max_new_tokens, kwargs)
        tm = telemetry.get_telemetry()
        if tm.enabled:
            tm.fleet_gauge("fleet/queue_depth", len(self._queue))

    # -- serving loop ------------------------------------------------------
    @property
    def has_work(self):
        return bool(self._queue) or self._backend.has_work

    @property
    def queue_depth(self):
        return len(self._queue)

    @property
    def shed_rate(self):
        return self.rejected / self.submitted if self.submitted else 0.0

    def _retire(self, uid):
        """Drop one uid from the backlog model (idempotent)."""
        placed = self._placed.pop(uid, None)
        if placed is not None:
            index, expected = placed
            self._backlog[index] = max(0, self._backlog[index] - expected)
        return placed is not None

    def step(self):
        """Drain the queue into freed capacity, run one backend round, and
        retire EVERY terminal outcome from the backlog model — finished
        uids from the step return, plus evict/cancel/replica-loss events
        from ``backend.drain_terminal()``. Anything less leaks phantom
        backlog and the TTFT predictions creep pessimistic until the
        router sheds a healthy fleet. Returns finished uids."""
        self._drain_queue()
        finished = self._backend.step()
        for uid in finished:
            self._retire(uid)
        drain = getattr(self._backend, "drain_terminal", None)
        if drain is not None:
            for uid, _outcome in drain():
                if self._retire(uid):
                    self.terminal_retired += 1
        return finished

    def results(self):
        """Generated tokens per admitted uid (shed requests never ran)."""
        return self._backend.results()

    def run_to_completion(self, max_rounds=10000):
        """Drain queue + backend; merged {uid: tokens} for everything that
        was admitted (shed requests never ran)."""
        for _ in range(max_rounds):
            if not self.has_work:
                break
            self.step()
        else:
            raise RuntimeError("router did not converge")
        return self.results()

    def report(self):
        """Admission accounting (``admitted + rejected == submitted`` once
        the queue is empty) + current backlog model. With telemetry on and
        SLO classes configured, ``slo_classes`` carries each class's live
        TTFT/TPOT percentiles and attainment."""
        rep = {"submitted": self.submitted, "admitted": self.admitted,
               "queued": self.queued, "rejected": self.rejected,
               "shed_rate": self.shed_rate,
               "queue_depth": len(self._queue),
               "affinity_hits": self.affinity_hits,
               "backlog_tokens": list(self._backlog),
               "terminal_retired": self.terminal_retired,
               "shed_by_class": {str(k): v
                                 for k, v in self.shed_by_class.items()},
               # accounting identity: every submit is admitted, rejected, or still queued; every
               # admitted-but-unfinished uid holds exactly its expected
               # tokens of backlog — drained fleets must show in_flight 0
               # and backlog_total 0
               "accounting": {
                   "in_flight": len(self._placed),
                   "backlog_total": sum(self._backlog),
                   "identity_holds": self.admitted + self.rejected
                   + len(self._queue) == self.submitted}}
        tm = telemetry.get_telemetry()
        snap = tm.slo_snapshot()
        if snap:
            slo = {}
            for cls, entry in snap.items():
                out = dict(entry)
                pcts = {}
                for metric in ("ttft", "tpot"):
                    p = tm.hist_percentiles(f"serving/{metric}_s/{cls}")
                    if p is not None:
                        pcts[metric] = {"p50_s": round(p[0], 6),
                                        "p95_s": round(p[1], 6),
                                        "p99_s": round(p[2], 6)}
                if pcts:
                    out["percentiles"] = pcts
                slo[cls] = out
            rep["slo_classes"] = slo
        return rep

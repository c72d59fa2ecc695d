"""Two-process KV fabric: prefill and decode in separate OS processes (port
of ``deepspeed_tpu/inference/v2/fleet/two_process.py``; the same protocol,
ops and frames).

The in-process fleet's wire codec serializes pages and immediately parses
them back — same address space, so "the wire" is an act of discipline. This
module removes the act: the PREFILL side lives in the parent process, the
DECODE side in a spawned child, and every KV page crosses the boundary as a
``fleet/wire.py`` frame over a duplex ``multiprocessing`` Pipe (the
socket-equivalent channel — ``Connection.send_bytes`` is length-prefixed
framing over a kernel pipe). The CRC32 check therefore runs on the
RECEIVING side of a real process boundary, exactly where a cross-host DCN
deployment runs it.

Determinism gives parity: both processes build the Llama with
``LlamaForCausalLM.from_seed(config, seed)`` (the two-process analog of
loading the same checkpoint; the child on the device the parent names), the
sampling stream is deterministic per (seed, position), and the parent
drives the child in lockstep (one ``step`` op per parent round), so greedy
output matches the in-process fleet token for token (pinned by
tests/test_torch_kv_fabric.py).

Control protocol (a JSON header, then an optional binary payload in chunks
of ``_CHUNK`` bytes)::

    parent -> child                      child -> parent
    ----------------------------------   --------------------------------
    query  {chains: {uid: [hex]}}        held    {held: {uid: n}}
    ship   {adopts: [...]} + frame       ack     {bound} | nak {error,
                                                 retryable}
    readmit{meta: {...}}                 ack
    step   {}                            stepped {finished, has_work}
    results{}                            results {outputs, stats}
    shutdown{}                           bye

A retryable nak (CRC mismatch — the frame was corrupted in flight) re-sends
the SAME frame (it is intact on the parent; the corruption models the
channel); exhaustion falls back to a ``readmit`` op — re-prefill on the
decode side, the same bit-exact fallback the in-process fleet uses — so a
poisoned link degrades throughput, never correctness and never a lost
request.
"""

import dataclasses
import json
import secrets

import numpy as np
import torch

from deepspeed_tpu_torch import resolve_device
from deepspeed_tpu_torch.inference.v2.fleet import wire
from deepspeed_tpu_torch.inference.v2.replica_group import (_ModelCopies,
                                                            build_device_replica,
                                                            on_device)
from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.resilience.faults import InjectedFault
from deepspeed_tpu_torch.utils.logging import logger

PROTOCOL_VERSION = 1

# a payload crosses the pipe in messages of at most this many bytes: a
# Connection reads each message with one buffer of the message's size, and a
# buffer of hundreds of MB per read costs more than the copy itself where
# the operating system maps large buffers slowly
_CHUNK = 256 << 10


def _send(conn, header, payload=b""):
    """One message: the JSON header (with the payload's length), then the
    payload in ``_CHUNK``-byte messages."""
    hb = json.dumps(header).encode()
    view = memoryview(payload)
    conn.send_bytes(len(hb).to_bytes(4, "little") + len(view).to_bytes(8, "little") + hb)
    for off in range(0, len(view), _CHUNK):
        conn.send_bytes(view[off:off + _CHUNK])


def _recv(conn):
    """The next ``_send``: (header, payload as a bytearray)."""
    raw = conn.recv_bytes()
    hl = int.from_bytes(raw[:4], "little")
    payload = bytearray(int.from_bytes(raw[4:12], "little"))
    off = 0
    while off < len(payload):
        off += conn.recv_bytes_into(payload, off)
    return json.loads(raw[12:12 + hl].decode()), payload


def _config_fields(config):
    """``LlamaConfig`` -> a plain dict that crosses a pipe (dtype by name)."""
    mc = dataclasses.asdict(config)
    mc["dtype"] = str(mc["dtype"]).removeprefix("torch.")
    return mc


def _build_decode_replica(model_config, seed, engine_config, token_budget,
                          device):
    """Deterministic from-scratch decode replica on ``device``: the child's
    analog of loading the checkpoint the parent serves. ``model_config`` is
    ``_config_fields`` of the parent's ``LlamaConfig``."""
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    mc = dict(model_config)
    mc["dtype"] = getattr(torch, mc["dtype"])
    device = resolve_device(device)
    model = LlamaForCausalLM.from_seed(LlamaConfig(**mc), int(seed), device=device)
    return build_device_replica(_ModelCopies(model), device, engine_config,
                                token_budget)


def _adopt_kwargs(meta):
    return dict(max_new_tokens=int(meta["max_new_tokens"]),
                eos_token_id=meta["eos_token_id"],
                temperature=float(meta["temperature"]),
                top_k=int(meta["top_k"]), top_p=float(meta["top_p"]),
                seed=int(meta["seed"]), slo_class=meta.get("slo_class"))


def decode_worker_main(conn, model_config, seed, engine_config, token_budget,
                       device):
    """Child process entry: serve the decode side of the fabric until a
    ``shutdown`` op. Every exception inside an op is answered as a ``nak``
    (typed by name) so the parent can distinguish the retryable CRC reject
    from a deterministic bind failure."""
    dev, sched = _build_decode_replica(model_config, seed, engine_config,
                                       token_budget, device)
    with on_device(dev):
        _serve(conn, dev, sched)


def _serve(conn, dev, sched):
    """The child's op loop (``decode_worker_main``)."""
    _send(conn, {"op": "ready", "protocol": PROTOCOL_VERSION})
    while True:
        header, payload = _recv(conn)
        op = header["op"]
        if op == "shutdown":
            _send(conn, {"op": "bye"})
            return
        if op == "query":
            chains = {int(u): [bytes.fromhex(d) for d in ds]
                      for u, ds in header["chains"].items()}
            held = sched.engine.held_prefix_lens(chains)
            _send(conn, {"op": "held",
                         "held": {str(u): int(n) for u, n in held.items()}})
        elif op == "ship":
            try:
                out = wire.decode_frame(payload, dev)
                bound = sched.engine.import_pages_many(out)
                for meta in header["adopts"]:
                    sched.adopt(
                        int(meta["uid"]),
                        np.asarray(meta["prompt"], np.int32),
                        [int(t) for t in meta["generated"]],
                        **_adopt_kwargs(meta))
                _send(conn, {"op": "ack", "bound": int(bound)})
            except Exception as e:  # answered, never fatal: the parent
                # retries (CRC) or falls back to a readmit (anything else)
                _send(conn, {"op": "nak",
                             "error": f"{type(e).__name__}: {e}",
                             "retryable":
                                 isinstance(e, wire.WireCRCError)})
        elif op == "readmit":
            meta = header["meta"]
            sched.readmit(int(meta["uid"]),
                          np.asarray(meta["prompt"], np.int32),
                          [int(t) for t in meta["generated"]],
                          **_adopt_kwargs(meta))
            _send(conn, {"op": "ack", "bound": 0})
        elif op == "step":
            finished = []
            if sched.has_work:
                finished = list(sched.step())
            _send(conn, {"op": "stepped",
                         "finished": [int(u) for u in finished],
                         "has_work": bool(sched.has_work)})
        elif op == "results":
            res = sched.results()
            _send(conn, {"op": "results",
                         "outputs": {str(u): [int(t) for t in v]
                                     for u, v in res.items()},
                         "kv_stats": {k: v for k, v in
                                      sched.kv_stats().items()
                                      if isinstance(v, (int, float))}})
        else:
            _send(conn, {"op": "nak", "error": f"unknown op {op!r}",
                         "retryable": False})


class TwoProcessFleet:
    """One prefill replica in THIS process, one decode replica in a spawned
    child; KV pages cross as serialized wire frames over a Pipe.

    The deliberately minimal fabric leg: same submit/step/results/
    run_to_completion surface as ``PrefillDecodeFleet`` (a caller drives
    both identically), one replica per side, re-prefill fallback on an
    unshippable handoff. The child rebuilds the model as
    ``LlamaForCausalLM.from_seed(model.config, seed)`` on ``decode_device``,
    so ``model`` must be that same draw (asserted nowhere: parity tests
    catch a mismatch immediately).

    Args:
        model: the parent's Llama, ``from_seed(config, seed)``.
        seed: the seed ``model`` was drawn from.
        device / decode_device: the parent's and the child's device
            (default: the current CUDA device for both; they may be the
            same card).
    """

    def __init__(self, model, seed=0, engine_config=None, token_budget=None,
                 decode_engine_config=None, decode_token_budget=None,
                 delta_shipping=True, wire_quantize=True, retries=2,
                 device=None, decode_device=None):
        import multiprocessing as mp

        self._device, self._sched = build_device_replica(
            _ModelCopies(model), device or "cuda", engine_config, token_budget)
        self._sched.on_finish = self._on_prefill_finish
        self._delta = bool(delta_shipping)
        self._wire_quantize = bool(wire_quantize)
        self._retries = int(retries)
        self._meta = {}
        self._pending = []       # requests awaiting ship this round
        self._remote_has_work = False
        # fabric counters (``stats()``)
        self.handoffs = 0
        self.transfers = 0
        self.pages_shipped = 0
        self.pages_delta_skipped = 0
        self.wire_bytes_shipped = 0
        self.wire_bytes_saved = 0
        self.crc_naks = 0
        self.fallbacks = 0
        self.lost_requests = 0
        ctx = mp.get_context("spawn")
        self._conn, child_conn = ctx.Pipe()
        self._proc = ctx.Process(
            target=decode_worker_main,
            args=(child_conn, _config_fields(model.config), seed,
                  decode_engine_config or engine_config,
                  decode_token_budget or token_budget,
                  str(resolve_device(decode_device or self._device))),
            daemon=True)
        self._proc.start()
        child_conn.close()
        header, _ = _recv(self._conn)
        if header.get("op") != "ready" or \
                header.get("protocol") != PROTOCOL_VERSION:
            raise RuntimeError(f"decode worker handshake failed: {header}")
        logger.info("TwoProcessFleet: decode worker pid "
                    f"{self._proc.pid} ready")

    # -- request surface ---------------------------------------------------
    def submit(self, uid, prompt, max_new_tokens=16, eos_token_id=None,
               temperature=0.0, top_k=0, top_p=1.0, seed=None,
               slo_class=None):
        if seed is None:
            seed = secrets.randbits(31)
        self._meta[uid] = {"uid": int(uid),
                           "max_new_tokens": int(max_new_tokens),
                           "eos_token_id": eos_token_id,
                           "temperature": float(temperature),
                           "top_k": int(top_k), "top_p": float(top_p),
                           "seed": int(seed), "slo_class": slo_class}
        with on_device(self._device):
            self._sched.submit(uid, prompt, max_new_tokens=1,
                               eos_token_id=eos_token_id,
                               temperature=temperature, top_k=top_k,
                               top_p=top_p, seed=seed, slo_class=slo_class)

    def _on_prefill_finish(self, sched, req):
        meta = self._meta.get(req.uid)
        if meta is None:
            return False
        tok = req.generated[-1]
        if len(req.generated) + req.pos_offset >= meta["max_new_tokens"] \
                or (meta["eos_token_id"] is not None and
                    tok == meta["eos_token_id"]):
            return False  # complete at prefill: normal flush + finish
        self._pending.append(req)
        return True

    # -- the fabric --------------------------------------------------------
    def _rpc(self, header, payload=b""):
        _send(self._conn, header, payload)
        return _recv(self._conn)

    def _flush_ships(self):
        if not self._pending:
            return
        reqs, self._pending = self._pending, []
        uids = [r.uid for r in reqs]
        engine = self._sched.engine
        skip = None
        if self._delta:
            chains = {u: c for u, c in
                      engine.sequence_block_digests(uids).items() if c}
            if chains:
                held, _ = self._rpc(
                    {"op": "query",
                     "chains": {str(u): [d.hex() for d in c]
                                for u, c in chains.items()}})
                skip = {int(u): n for u, n in held["held"].items() if n} \
                    or None
        with on_device(self._device):
            handle = engine.export_pages_many(uids, skip=skip) if skip \
                else engine.export_pages_many(uids)
            frame = wire.encode_handle(handle, fetch=engine.host_fetch,
                                       wire_quantize=self._wire_quantize)
        adopts = [dict(self._meta[r.uid],
                       prompt=[int(t) for t in r.prompt],
                       generated=[int(t) for t in r.generated])
                  for r in reqs]
        skipped = sum(int(m.get("skipped", 0)) for m in handle["seqs"])
        per_page = len(frame) // max(int(handle["n"]), 1)
        for attempt in range(self._retries + 1):
            send_frame = frame
            try:
                faults.maybe_fail("transport.corrupt", "two_process")
            except InjectedFault:
                send_frame = wire.corrupt(frame)
            header, _ = self._rpc({"op": "ship", "adopts": adopts},
                                  send_frame)
            if header["op"] == "ack":
                self.handoffs += len(reqs)
                self.transfers += 1
                self.pages_shipped += int(handle["n"])
                self.pages_delta_skipped += skipped
                self.wire_bytes_shipped += len(frame)
                self.wire_bytes_saved += skipped * per_page
                self._remote_has_work = True
                return
            if header.get("retryable"):
                self.crc_naks += 1
                continue
            break  # deterministic reject: no retry can help
        # exhausted or non-retryable: bit-exact re-prefill on the decode
        # side (the pages left the parent with the export — only the
        # prefill compute is paid again)
        logger.warning(f"two-process handoff failed for uids {uids} "
                       f"({header.get('error')}); re-prefilling remotely")
        for a in adopts:
            self._rpc({"op": "readmit", "meta": a})
            self.fallbacks += 1
        self._remote_has_work = True

    # -- serving loop ------------------------------------------------------
    @property
    def has_work(self):
        return self._sched.has_work or bool(self._pending) or \
            self._remote_has_work

    def step(self):
        """One lockstep round: parent prefill forward, ship the round's
        finished prefills, then one decode round in the child. Returns
        uids that finished on either side this round."""
        finished = []
        if self._sched.has_work:
            with on_device(self._device):
                finished = list(self._sched.step())
        self._flush_ships()
        header, _ = self._rpc({"op": "step"})
        self._remote_has_work = bool(header["has_work"])
        finished.extend(header["finished"])
        return finished

    def run_to_completion(self, max_rounds=10000):
        for _ in range(max_rounds):
            if not self.has_work:
                break
            self.step()
        else:
            raise RuntimeError("two-process fleet did not converge")
        return self.results()

    def results(self):
        """Merged {uid: tokens}; child-side entries win (they extend the
        prefill side's first token)."""
        out = {u: np.asarray(v, np.int32)
               for u, v in self._sched.results().items()}
        header, _ = self._rpc({"op": "results"})
        for u, v in header["outputs"].items():
            out[int(u)] = np.asarray(v, np.int32)
        return out

    def stats(self):
        return {"handoffs": self.handoffs, "transfers": self.transfers,
                "pages_shipped": self.pages_shipped,
                "pages_delta_skipped": self.pages_delta_skipped,
                "wire_bytes_shipped": self.wire_bytes_shipped,
                "wire_bytes_saved": self.wire_bytes_saved,
                "crc_naks": self.crc_naks, "fallbacks": self.fallbacks,
                "lost_requests": self.lost_requests}

    def close(self):
        if self._proc is None:
            return
        try:
            self._rpc({"op": "shutdown"})
        except (EOFError, OSError, BrokenPipeError):
            pass
        self._proc.join(timeout=30)
        if self._proc.is_alive():
            self._proc.terminate()
        self._conn.close()
        self._proc = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

"""Host-DRAM KV page swapper: double-buffered device->host spills (port of
``deepspeed_tpu/runtime/swap_tensor/kv_swapper.py``).

Parked prefix-cache blocks spill their pages to host memory instead of being
evicted, so the prefix cache outgrows the device pool. The caller gathers a
block's pages on the device and hands the gathered tensors to ``submit``. On
CUDA the swapper starts their copy into pinned host memory on its own copy
stream at once, after an event on the compute stream (the gather must have
run), and records an event behind the copy; nothing blocks. When more than
``buffer_count`` payloads are pending, the oldest is *landed*: its event is
synchronised, and its gathered device tensors are dropped. Decode steps
launched between submit and landing overlap the copies. The gathered
tensors stay referenced by the payload until it lands, so the caching
allocator cannot hand their memory to another tensor while the copy still
reads it. On the CPU the gathered tensors are the host copy already.

Every landing passes the host tensors through the injected accounted fetch
``fetch(tensors, what)`` (the engine's ``host_fetch``, so that
``host_sync_count`` sees each landing, as the JAX engine's host-sync ratchet
does), inside ``land_wrapper(thunk)`` when one is set, so the caller can time
it. ``land`` of a still-pending payload lands it first; a landed payload
holds host tensors. Payloads are single-use (the allocator's spill-handle
contract).
"""

from collections import deque

import torch


class _Payload:
    """One spilled block's pages: host tensors (pinned on CUDA), valid once
    landed; until then, on CUDA, also the gathered device tensors and the
    copy's event."""

    __slots__ = ("arrays", "landed", "_device", "_event")

    def __init__(self, arrays, device, event):
        self.arrays = arrays     # tuple of host tensors
        self.landed = False
        self._device = device    # gathered device tensors, kept until landed
        self._event = event      # the copy's completion (CUDA), or None


class HostKVSwapper:

    def __init__(self, fetch=None, buffer_count=2, land_wrapper=None):
        """``fetch(tensors, what)`` -> host tensor tuple: the accounted
        landing (identity when None). ``land_wrapper(thunk)``, when set, runs
        each landing's thunk — the caller decides whether to time it."""
        self._fetch = fetch
        self._buffer_count = max(1, int(buffer_count))
        self._pending = deque()      # _Payload entries, oldest first
        self.land_wrapper = land_wrapper
        self._copy_stream = None     # made at the first CUDA submit
        self.landings = 0

    @property
    def pending(self) -> int:
        return len(self._pending)

    def submit(self, tensors):
        """Start copying gathered device tensors to host memory as a new
        payload; lands the oldest entries beyond the double-buffer depth.
        Returns the payload (the allocator's opaque spill record)."""
        tensors = tuple(tensors)
        if tensors and tensors[0].device.type == "cuda":
            p = self._submit_cuda(tensors)
        else:
            p = _Payload(tensors, (), None)
        self._pending.append(p)
        while len(self._pending) > self._buffer_count:
            self._land(self._pending.popleft())
        return p

    def _submit_cuda(self, tensors):
        device = tensors[0].device
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device)
        compute = torch.cuda.current_stream(device)
        self._copy_stream.wait_stream(compute)    # the gathers have run
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in tensors)
        with torch.cuda.stream(self._copy_stream):
            for h, t in zip(host, tensors):
                h.copy_(t, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return _Payload(host, tensors, event)

    def land(self, payload):
        """Finish a payload's copy (a restore of a pending spill) and return
        its host tensors."""
        if not payload.landed:
            self._pending.remove(payload)
            self._land(payload)
        return payload.arrays

    def drain(self):
        """Land everything pending (shutdown / barrier)."""
        while self._pending:
            self._land(self._pending.popleft())

    def _land(self, payload):
        def thunk():
            if payload._event is not None:
                payload._event.synchronize()
            if self._fetch is None:
                return payload.arrays
            return tuple(self._fetch(payload.arrays, "kv_cache/spill"))

        payload.arrays = thunk() if self.land_wrapper is None \
            else self.land_wrapper(thunk)
        payload._device = ()
        payload._event = None
        payload.landed = True
        self.landings += 1

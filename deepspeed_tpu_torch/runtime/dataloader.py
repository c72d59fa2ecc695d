"""Dataloader for one rank (port of ``deepspeed_tpu/runtime/dataloader.py``).

``DeepSpeedDataLoader`` wraps an indexable dataset (a dict of arrays, a list
of samples) or an iterable of ready batches and yields numpy batches of
``batch_size`` rows, shuffled from ``seed`` as in the JAX package; the engine
moves each batch to its device. With ``dp_world`` ranks, every rank draws
the same global micro-batches of ``batch_size * dp_world`` rows (the JAX
loader's batches) and rank ``dp_rank`` yields the ``dp_rank``-th contiguous
block of ``batch_size`` rows of each, which is where the JAX mesh places it
(``batch_spec``); a ready batch of an iterable dataset is a global one and
is cut the same way. ``RepeatingLoader`` restarts the wrapped loader when it
runs out. ``PrefetchLoader`` (the engine's ``prefetch_batches``) assembles
the next batches in a worker thread and copies them to the device ahead of
the step.
"""

import queue
import threading

import numpy as np
import torch


def _stack(samples):
    """Stack a list of samples (arrays, dicts or tuples of arrays) leaf-wise."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: _stack([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack(list(xs)) for xs in zip(*samples))
    return np.stack([np.asarray(s) for s in samples])


class DeepSpeedDataLoader:

    def __init__(self, dataset, batch_size, collate_fn=None, shuffle=True,
                 seed=0, drop_last=True, dp_rank=0, dp_world=1):
        self.dataset = dataset
        self.local_batch_size = batch_size
        self.batch_size = batch_size * dp_world    # the global micro-batch
        self.dp_rank = dp_rank
        self.dp_world = dp_world
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self._epoch = 0
        if hasattr(dataset, "__len__") and not isinstance(dataset, dict):
            self.num_samples = len(dataset)
        elif isinstance(dataset, dict):
            self.num_samples = len(next(iter(dataset.values())))
        else:
            self.num_samples = None  # pure iterable

    def __len__(self):
        if self.num_samples is None:
            raise TypeError("iterable dataset has no length")
        n = self.num_samples // self.batch_size
        if not self.drop_last and self.num_samples % self.batch_size:
            n += 1
        return n

    def _index_batches(self):
        idx = np.arange(self.num_samples)
        if self.shuffle:
            self._rng.shuffle(idx)
        end = (self.num_samples // self.batch_size) * self.batch_size if self.drop_last \
            else self.num_samples
        for start in range(0, end, self.batch_size):
            yield idx[start:start + self.batch_size]

    def _local(self, batch):
        """This rank's block of rows of a global batch."""
        if self.dp_world == 1:
            return batch
        lo = self.dp_rank * self.local_batch_size
        if isinstance(batch, dict):
            return {k: self._local(v) for k, v in batch.items()}
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._local(v) for v in batch)
        return np.asarray(batch)[lo:lo + self.local_batch_size]

    def __iter__(self):
        self._epoch += 1
        if self.num_samples is None:
            for batch in self.dataset:
                yield self._local(batch)
            return
        for batch_idx in self._index_batches():
            if self.dp_world > 1:
                lo = self.dp_rank * self.local_batch_size
                batch_idx = batch_idx[lo:lo + self.local_batch_size]
            if isinstance(self.dataset, dict):
                yield {k: np.asarray(v)[batch_idx] for k, v in self.dataset.items()}
            else:
                samples = [self.dataset[int(i)] for i in batch_idx]
                yield self.collate_fn(samples) if self.collate_fn is not None \
                    else _stack(samples)


class RepeatingLoader:
    """Wraps a loader so that iteration never ends."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class PrefetchLoader:
    """Background batch assembly and ahead-of-time device placement (JAX
    ``dataloader.py:87-170``, where ``jax.device_put``'s asynchronous
    dispatch is the copy stream). A worker thread iterates ``loader``,
    stages each batch's arrays in pinned host memory and copies them to
    ``device`` with ``non_blocking`` copies on a side stream, recording an
    event; the consumer's stream waits on that event (no host wait) when it
    takes the batch. At most ``depth`` batches are resident ahead of the
    consumer. On the CPU the worker only converts the arrays to tensors.
    Each pass over the loader has its own worker; an abandoned pass's worker
    is released."""

    _END = object()

    def __init__(self, loader, device=None, depth=2):
        from deepspeed_tpu_torch import resolve_device
        self.loader = loader
        self.device = resolve_device(device)
        self.depth = max(1, int(depth))
        self._active_cancel = None
        self._stream = None

    def __len__(self):
        return len(self.loader)

    def __getattr__(self, name):
        # the wrapped loader's surface (batch_size, dataset, ...)
        return getattr(self.loader, name)

    def _put(self, batch):
        """``batch`` on the device: (tensors, the copies' event or None)."""
        if self.device.type != "cuda":
            return _map(batch, torch.as_tensor), None
        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._stream):
                out = _map(batch, lambda x: torch.as_tensor(np.asarray(x)).pin_memory().to(
                    self.device, non_blocking=True))
                event = torch.cuda.Event()
                event.record(self._stream)
        return out, event

    def __iter__(self):
        q = queue.Queue()
        slots = threading.Semaphore(self.depth)
        cancel = threading.Event()
        if self._active_cancel is not None:
            self._active_cancel.set()
        self._active_cancel = cancel

        def worker():
            try:
                for batch in self.loader:
                    while not slots.acquire(timeout=0.1):
                        if cancel.is_set():
                            return
                    if cancel.is_set():
                        return
                    q.put(self._put(batch))
            except Exception as e:  # surfaced at the consumer's next next()
                q.put(e)
                return
            q.put(self._END)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is self._END:
                return
            if isinstance(item, Exception):
                raise item
            batch, event = item
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                _map(batch, lambda t: t.record_stream(stream))
            try:
                yield batch
            finally:
                slots.release()


def _map(batch, fn):
    if isinstance(batch, dict):
        return {k: _map(v, fn) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(v, fn) for v in batch)
    return fn(batch)

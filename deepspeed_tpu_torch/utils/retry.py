"""Retry with exponential backoff + full jitter + deadline (the port's own
copy of ``deepspeed_tpu/utils/retry.py``; pure Python).

The one backoff policy shared by every transient-failure path in the
runtime: ``comm.init_distributed`` (coordinator races at gang start),
checkpoint host I/O (NFS/GCS blips), and the elastic agent's relaunch loop
(docs/RESILIENCE.md). Full jitter follows the AWS architecture-blog result:
``delay = uniform(0, min(max_delay, base * factor**attempt))`` decorrelates
a gang of workers all retrying the same failed resource.

Deterministic by construction: the RNG, clock and sleep are all injectable,
so tests (and the fault drill) can pin exact delay sequences.
"""

import random
import time


class RetryError(RuntimeError):
    """Raised when retries are exhausted or the deadline would be exceeded.
    ``last`` holds the final underlying exception; ``attempts`` how many
    calls were made."""

    def __init__(self, msg, last=None, attempts=0):
        super().__init__(msg)
        self.last = last
        self.attempts = attempts


class BackoffPolicy:
    """Exponential backoff with optional full jitter.

    ``delay(attempt)`` maps a 1-based attempt number to a sleep in seconds:
    cap = min(max_delay, base * factor**(attempt-1)); full jitter draws
    uniform(0, cap), "none" returns the cap itself (deterministic ladders
    for tests and for the elastic agent's logged schedule).
    """

    def __init__(self, base=0.5, factor=2.0, max_delay=30.0, jitter="full",
                 rng=None):
        if base < 0 or factor < 1.0 or max_delay < 0:
            raise ValueError(f"invalid backoff: base={base} factor={factor} "
                             f"max_delay={max_delay}")
        if jitter not in ("full", "none"):
            raise ValueError(f"jitter must be 'full' or 'none', got {jitter!r}")
        self.base = base
        self.factor = factor
        self.max_delay = max_delay
        self.jitter = jitter
        self._rng = rng if rng is not None else random.Random()

    def cap(self, attempt):
        """The un-jittered ceiling for ``attempt`` (1-based)."""
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt}")
        return min(self.max_delay, self.base * self.factor ** (attempt - 1))

    def delay(self, attempt):
        c = self.cap(attempt)
        if self.jitter == "none":
            return c
        return self._rng.uniform(0.0, c)


def retry_call(fn, *args, retries=3, base_delay=0.5, factor=2.0,
               max_delay=30.0, deadline=None, jitter="full",
               retry_on=(OSError,), rng=None, sleep=time.sleep,
               clock=time.monotonic, on_retry=None, **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying on ``retry_on`` exceptions.

    - ``retries``: number of retries AFTER the first attempt (so up to
      ``retries + 1`` calls total).
    - ``deadline``: wall-clock budget in seconds from the first attempt; a
      retry whose backoff sleep would overrun it raises :class:`RetryError`
      immediately instead of sleeping past the budget.
    - ``on_retry(attempt, exc, delay)``: observation hook (logging,
      telemetry) before each sleep.

    Exhaustion raises :class:`RetryError` with the last exception chained
    (``raise ... from last``); non-matching exceptions propagate untouched.
    """
    policy = BackoffPolicy(base=base_delay, factor=factor,
                           max_delay=max_delay, jitter=jitter, rng=rng)
    t0 = clock()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if attempt > retries:
                raise RetryError(
                    f"{getattr(fn, '__name__', fn)!s} failed after "
                    f"{attempt} attempts: {type(e).__name__}: {e}",
                    last=e, attempts=attempt) from e
            d = policy.delay(attempt)
            if deadline is not None and (clock() - t0) + d > deadline:
                raise RetryError(
                    f"{getattr(fn, '__name__', fn)!s}: deadline {deadline}s "
                    f"would be exceeded after {attempt} attempts "
                    f"({type(e).__name__}: {e})",
                    last=e, attempts=attempt) from e
            if on_retry is not None:
                on_retry(attempt, e, d)
            sleep(d)


def retryable(**retry_kwargs):
    """Decorator form of :func:`retry_call`::

        @retryable(retries=2, retry_on=(OSError,))
        def write_shard(path): ...
    """
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return retry_call(fn, *args, **retry_kwargs, **kwargs)
        return wrapper
    return deco

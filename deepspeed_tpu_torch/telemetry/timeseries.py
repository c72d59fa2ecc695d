"""Fixed-window ring-buffer time series (port of
``deepspeed_tpu/telemetry/timeseries.py``).

The telemetry layer's histograms and ``{last, peak}`` gauges compress a run
into one number per stream. ``SeriesRing`` adds the time dimension at O(1)
memory: time is cut into fixed windows of ``window_s`` seconds and each
recorded value folds into its window's running ``count/sum/min/max``. Only
the most recent ``num_windows`` windows are kept — older ones fall off the
ring.

Standard library only and clock-free: the caller passes every timestamp
explicitly (``telemetry/core.py`` owns the injectable ``_now`` clock and
reads it at most once per record).

Semantics:

- a record at time ``ts`` lands in window ``floor(ts / window_s)``;
- the newest window ever recorded defines the ring head; records older
  than ``head - num_windows + 1`` windows are dropped (too old to keep);
- windows with no records simply don't exist (sparse — a clock skip
  leaves a gap, not a run of zero windows);
- ``windows()`` returns the live windows in chronological order.
"""

FORMAT_VERSION = 1

#: defaults used by telemetry/core.py for every series stream
DEFAULT_WINDOW_S = 0.5
DEFAULT_NUM_WINDOWS = 64

# slot layout: [window_index, count, sum, min, max]
_IDX, _COUNT, _SUM, _MIN, _MAX = range(5)


class SeriesRing:
    """One stream's fixed-window rollups over a ring of ``num_windows``."""

    __slots__ = ("window_s", "num_windows", "_slots", "_head",
                 "total_count", "total_sum")

    def __init__(self, window_s=DEFAULT_WINDOW_S,
                 num_windows=DEFAULT_NUM_WINDOWS):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if num_windows < 1:
            raise ValueError(f"num_windows must be >= 1, got {num_windows}")
        self.window_s = float(window_s)
        self.num_windows = int(num_windows)
        self._slots = [None] * self.num_windows
        self._head = None  # newest window index ever recorded
        # lifetime totals survive ring eviction (attainment arithmetic
        # must hold over the WHOLE run, not just the live windows)
        self.total_count = 0
        self.total_sum = 0.0

    def record(self, ts, value):
        """Fold ``value`` into the window containing ``ts`` (seconds).

        Returns True when the record landed, False when it was older than
        the ring's tail and dropped.
        """
        v = float(value)
        idx = int(ts // self.window_s)
        head = self._head
        if head is not None and idx <= head - self.num_windows:
            return False  # older than the ring's tail
        self.total_count += 1
        self.total_sum += v
        if head is None or idx > head:
            self._head = idx
        slot = self._slots[idx % self.num_windows]
        if slot is None or slot[_IDX] != idx:
            self._slots[idx % self.num_windows] = [idx, 1, v, v, v]
            return True
        slot[_COUNT] += 1
        slot[_SUM] += v
        if v < slot[_MIN]:
            slot[_MIN] = v
        if v > slot[_MAX]:
            slot[_MAX] = v
        return True

    def windows(self):
        """Live windows, oldest first:
        ``[{index, start_s, count, sum, min, max, mean}, ...]``."""
        if self._head is None:
            return []
        tail = self._head - self.num_windows  # exclusive lower bound
        live = [s for s in self._slots if s is not None and s[_IDX] > tail]
        live.sort(key=lambda s: s[_IDX])
        return [{"index": s[_IDX],
                 "start_s": round(s[_IDX] * self.window_s, 9),
                 "count": s[_COUNT],
                 "sum": s[_SUM],
                 "min": s[_MIN],
                 "max": s[_MAX],
                 "mean": s[_SUM] / s[_COUNT]} for s in live]

    def rate_per_s(self, last_n=None):
        """Mean records/second over the live windows (optionally the last
        ``last_n``) — the burn-rate numerator for counter-style series."""
        win = self.windows()
        if last_n is not None:
            win = win[-last_n:]
        if not win:
            return 0.0
        return sum(w["count"] for w in win) / (len(win) * self.window_s)

    def mean_over(self, last_n=None):
        """Value-weighted mean over the live windows (optionally the last
        ``last_n``); 0.0 when empty."""
        win = self.windows()
        if last_n is not None:
            win = win[-last_n:]
        total = sum(w["count"] for w in win)
        if not total:
            return 0.0
        return sum(w["sum"] for w in win) / total

    def summary(self):
        """JSON-ready dict for ``telemetry.summary()['timeseries']``."""
        return {"window_s": self.window_s,
                "num_windows": self.num_windows,
                "total_count": self.total_count,
                "total_sum": self.total_sum,
                "windows": self.windows()}

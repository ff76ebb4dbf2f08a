"""Bounded metrics registry: counters, gauges, log-linear histograms.

The always-on runtime must report latency quantiles over unbounded
uptime, so every instrument here is O(1) memory regardless of how many
samples it has absorbed:

* ``Counter`` / ``Gauge`` — one scalar each.
* ``Histogram`` — fixed-bucket *log-linear* histogram (HdrHistogram's
  bucket geometry): each power-of-two range ``[2^e, 2^(e+1))`` splits
  into ``lin`` equal sub-buckets, so the worst-case relative quantile
  error is bounded by ``1/lin`` (~3% at the default ``lin=32``) at every
  scale from ``lo`` to ``hi``.  ``count``/``sum``/``min``/``max`` are
  tracked exactly; ``quantile`` interpolates inside the landing bucket.
* ``Reservoir`` — a ring of the *last* ``capacity`` raw samples.  While
  fewer than ``capacity`` samples have been recorded it holds every one
  of them, so short windows (tests, benches) get **exact** percentiles;
  once it wraps, callers fall back to the histogram estimate and label
  it as such (see ``stream/metrics.py``).

``MetricsRegistry`` is a flat name -> instrument namespace with a
JSON-able ``snapshot()`` (strict JSON: empty histograms omit their
quantile fields instead of emitting NaN).
"""
from __future__ import annotations

import json
import math

import numpy as np


class Counter:
    """Monotone event count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str = "") -> None:
        self.name = name
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins instantaneous value (occupancy, capacity, ...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str = "") -> None:
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self):
        return self.value


class Reservoir:
    """Ring buffer of the last ``capacity`` samples — exact while short.

    ``values()`` returns the retained samples in ring order (order is
    irrelevant to percentiles); ``saturated`` flips once the ring has
    wrapped, i.e. once the retained window no longer covers every sample
    ever recorded.
    """

    __slots__ = ("_data", "count", "capacity")

    def __init__(self, capacity: int = 4096) -> None:
        assert capacity > 0
        self._data = np.zeros(capacity, np.float64)
        self.count = 0
        self.capacity = capacity

    @property
    def saturated(self) -> bool:
        return self.count > self.capacity

    def record(self, v: float) -> None:
        self._data[self.count % self.capacity] = v
        self.count += 1

    def values(self) -> np.ndarray:
        return self._data[: min(self.count, self.capacity)]

    def reset(self) -> None:
        self.count = 0

    @property
    def nbytes(self) -> int:
        return self._data.nbytes


class Histogram:
    """Fixed-bucket log-linear histogram with bounded relative error.

    Bucket ``(e, s)`` covers ``[2^e * (1 + s/lin), 2^e * (1 + (s+1)/lin))``
    for exponents ``e`` spanning ``[lo, hi)``; values outside clamp into
    one underflow and one overflow bucket (tracked, and ``min``/``max``
    stay exact, so clamping is visible).  Memory is a single fixed int64
    count vector — independent of sample count, the property the
    always-on runtime needs.
    """

    __slots__ = ("name", "lin", "_min_exp", "_n_exp", "_lo", "_hi",
                 "_nb", "_counts", "count", "sum", "min", "max")

    def __init__(self, name: str = "", lin: int = 32,
                 lo: float = 1e-7, hi: float = 1e4) -> None:
        assert lin >= 2 and 0 < lo < hi
        self.name = name
        self.lin = lin
        self._min_exp = math.frexp(lo)[1] - 1  # floor(log2(lo))
        self._n_exp = (math.frexp(hi)[1] - 1) - self._min_exp + 1
        self._lo = float(lo)
        self._hi = float(hi)
        # [underflow, body..., overflow]; a plain list keeps the
        # single-sample increment off numpy's scalar-indexing overhead —
        # ``record`` sits on the per-hop hot path
        self._nb = self._n_exp * lin + 2
        self._counts = [0] * self._nb
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- recording -----------------------------------------------------------

    def _index(self, v: float) -> int:
        if v < self._lo:
            return 0
        if v >= self._hi:
            return self._nb - 1
        m, e = math.frexp(v)           # v = m * 2^e, m in [0.5, 1)
        sub = int((2.0 * m - 1.0) * self.lin)
        return 1 + (e - 1 - self._min_exp) * self.lin + min(sub, self.lin - 1)

    def record(self, v: float) -> None:
        v = float(v)
        self._counts[self._index(v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def record_many(self, values: np.ndarray) -> None:
        """Vectorized ``record`` for bulk backfill (one ``np.add.at``) —
        how a wrapping ``Reservoir``'s retained window folds in (see
        ``stream/metrics.py``) without ever paying per-sample cost."""
        v = np.asarray(values, np.float64).reshape(-1)
        if v.size == 0:
            return
        m, e = np.frexp(np.clip(v, self._lo, None))
        sub = np.minimum((2.0 * m - 1.0) * self.lin, self.lin - 1).astype(
            np.int64
        )
        idx = 1 + (e - 1 - self._min_exp) * self.lin + sub
        idx = np.where(v < self._lo, 0, idx)
        idx = np.where(v >= self._hi, self._nb - 1, idx)
        binc = np.zeros(self._nb, np.int64)
        np.add.at(binc, idx, 1)
        counts = self._counts
        for i in np.nonzero(binc)[0]:
            counts[i] += int(binc[i])
        self.count += v.size
        self.sum += float(v.sum())
        self.min = min(self.min, float(v.min()))
        self.max = max(self.max, float(v.max()))

    def reset(self) -> None:
        self._counts = [0] * self._nb
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- reporting -----------------------------------------------------------

    def _edges(self, i: int) -> tuple[float, float]:
        """[lower, upper) value edges of body bucket index ``i`` (0-based
        within the body, i.e. ``counts`` index ``i + 1``)."""
        e = self._min_exp + i // self.lin
        s = i % self.lin
        base = math.ldexp(1.0, e)
        return base * (1 + s / self.lin), base * (1 + (s + 1) / self.lin)

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile (0..1); NaN when empty.

        Interpolates linearly inside the landing bucket, clamped to the
        exact observed ``min``/``max`` so the estimate never leaves the
        recorded range (and under/overflow buckets report those exact
        extremes rather than a fabricated edge).
        """
        if self.count == 0:
            return math.nan
        rank = q * (self.count - 1)
        cum = 0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            if rank < cum + c:
                if i == 0:
                    return self.min
                if i == self._nb - 1:
                    return self.max
                vlo, vhi = self._edges(i - 1)
                frac = (rank - cum + 0.5) / c
                est = vlo + (vhi - vlo) * frac
                return min(max(est, self.min), self.max)
            cum += c
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    @property
    def nbytes(self) -> int:
        return 8 * self._nb

    def snapshot(self) -> dict[str, float]:
        """Strict-JSON summary: quantiles appear only when non-empty."""
        out: dict[str, float] = {"count": float(self.count), "sum": self.sum}
        if self.count:
            out.update(
                min=self.min, max=self.max,
                p50=self.quantile(0.50), p95=self.quantile(0.95),
                p99=self.quantile(0.99), p999=self.quantile(0.999),
            )
        return out


class MetricsRegistry:
    """Flat name -> instrument namespace with get-or-create accessors.

    One registry serves a whole runtime (scheduler + engine + benches);
    ``snapshot()`` is a plain dict safe for ``json.dumps(...,
    allow_nan=False)``, the export the bench artifact embeds.
    """

    def __init__(self) -> None:
        self._series: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, cls, **kw):
        inst = self._series.get(name)
        if inst is None:
            inst = self._series[name] = cls(name, **kw)
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, not {cls.__name__}"
            )
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get(name, Histogram, **kw)

    def __contains__(self, name: str) -> bool:
        return name in self._series

    def names(self) -> list[str]:
        return sorted(self._series)

    def snapshot(self) -> dict[str, object]:
        return {k: self._series[k].snapshot() for k in self.names()}

    def to_json(self, **kw) -> str:
        kw.setdefault("allow_nan", False)
        return json.dumps(self.snapshot(), **kw)

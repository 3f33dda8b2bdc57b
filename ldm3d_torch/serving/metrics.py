"""Minimal Prometheus-compatible metrics (counter/gauge/histogram + text format).

The port's own copy of ``ldm3d_tpu/serving/metrics.py`` (pure Python): request
counts and durations, inference duration, active requests and memory gauges,
exposed at ``GET /metrics`` in the Prometheus text exposition format, with no
dependency on ``prometheus_client``.
"""

from __future__ import annotations

import threading
from typing import Sequence

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY"]


class _Metric:
    def __init__(self, name: str, help_: str, labels: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(labels)
        self._lock = threading.Lock()

    def _key(self, label_values: tuple) -> tuple:
        if len(label_values) != len(self.label_names):
            raise ValueError(f"{self.name}: expected labels {self.label_names}")
        return label_values

    @staticmethod
    def _fmt_labels(names, values) -> str:
        if not names:
            return ""
        inner = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
        return "{" + inner + "}"


class Counter(_Metric):
    def __init__(self, name, help_, labels=()):
        super().__init__(name, help_, labels)
        self._values: dict[tuple, float] = {}

    def labels(self, *values) -> "Counter._Child":
        return Counter._Child(self, self._key(tuple(values)))

    def inc(self, amount: float = 1.0):
        if self.label_names:
            raise ValueError("labeled counter requires .labels()")
        with self._lock:
            self._values[()] = self._values.get((), 0.0) + amount

    class _Child:
        def __init__(self, parent, key):
            self.parent, self.key = parent, key

        def inc(self, amount: float = 1.0):
            with self.parent._lock:
                self.parent._values[self.key] = self.parent._values.get(self.key, 0.0) + amount

    def collect(self) -> list[tuple[tuple, float]]:
        """Snapshot of (label_values, count) pairs — for tests/introspection."""
        with self._lock:
            return list(self._values.items())

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            if not self._values and not self.label_names:
                self._values[()] = 0.0
            for key, v in sorted(self._values.items()):
                lines.append(f"{self.name}{self._fmt_labels(self.label_names, key)} {v}")
        return "\n".join(lines)


class Gauge(_Metric):
    def __init__(self, name, help_, labels=()):
        super().__init__(name, help_, labels)
        self._value = 0.0

    def set(self, v: float):
        with self._lock:
            self._value = float(v)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    def expose(self) -> str:
        return (f"# HELP {self.name} {self.help}\n# TYPE {self.name} gauge\n"
                f"{self.name} {self._value}")


class Histogram(_Metric):
    DEFAULT_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, float("inf"))

    def __init__(self, name, help_, buckets: Sequence[float] | None = None):
        super().__init__(name, help_)
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self._counts = [0] * len(self.buckets)
        self._sum = 0.0
        self._n = 0

    def observe(self, v: float):
        with self._lock:
            self._sum += v
            self._n += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            for b, c in zip(self.buckets, self._counts):
                le = "+Inf" if b == float("inf") else repr(b)
                lines.append(f'{self.name}_bucket{{le="{le}"}} {c}')
            lines.append(f"{self.name}_sum {self._sum}")
            lines.append(f"{self.name}_count {self._n}")
        return "\n".join(lines)


class Registry:
    def __init__(self):
        self._metrics: list = []
        self._lock = threading.Lock()

    def register(self, metric):
        with self._lock:
            self._metrics.append(metric)
        return metric

    def expose(self) -> str:
        with self._lock:
            return "\n".join(m.expose() for m in self._metrics) + "\n"


REGISTRY = Registry()

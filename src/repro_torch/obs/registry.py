"""Typed serving-metrics registry: counters / gauges / histograms with
labels, Prometheus text exposition and JSON snapshots (port of
``repro/obs/registry.py``; a copy of that jax-free module, kept here so the
port imports nothing of the reference package: the same operations give
byte-equal Prometheus text).

The registry is the one aggregation point the serving stack writes into:
``RunMetrics`` (serve/metrics.py) feeds per-request latency histograms and
completion counters as requests finish, and publishes its end-of-window
summary as ``serve_run_*`` gauges, so a ``--metrics-out`` dump and the
printed summary read one source of truth.

Semantics follow Prometheus conventions:

- **counters** are monotone over the registry's life — a warmup run plus a
  timed run both count (windowed deltas are the *reader's* job, exactly as
  with scraped Prometheus counters);
- **gauges** are last-write-wins (``serve_run_*`` gauges therefore reflect
  the most recently published RunMetrics window);
- **histograms** expose cumulative bucket counts + sum + count.

Label names are declared at metric creation and every observation must bind
all of them (mode / engine / route for the serving stack), so exposition is
well-formed by construction.
"""
from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "parse_prometheus",
]

# latency-shaped buckets (seconds): serving TTFT/TPOT land between 100us
# and a few seconds, from the CPU's plain path to the card
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _check_name(name: str, what: str = "metric") -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid {what} name {name!r}")
    return name


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = ()):
        self.name = _check_name(name)
        self.help = help
        self.label_names: Tuple[str, ...] = tuple(labels)
        for ln in self.label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.label_names)}"
            )
        return tuple(str(labels[ln]) for ln in self.label_names)

    def _label_str(self, key: Tuple[str, ...]) -> str:
        if not key:
            return ""
        pairs = ",".join(f'{ln}="{_escape(v)}"'
                         for ln, v in zip(self.label_names, key))
        return "{" + pairs + "}"

    def _label_dict(self, key: Tuple[str, ...]) -> Dict[str, str]:
        return dict(zip(self.label_names, key))


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = ()):
        super().__init__(name, help, labels)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"{self.name}: counters only go up (got {value})")
        key = self._key(labels)
        self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    def expose(self) -> Iterable[str]:
        for key, v in sorted(self._values.items()):
            yield f"{self.name}{self._label_str(key)} {_fmt(v)}"

    def snapshot(self) -> List[Dict]:
        return [{"labels": self._label_dict(k), "value": v}
                for k, v in sorted(self._values.items())]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = ()):
        super().__init__(name, help, labels)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels) -> None:
        self._values[self._key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        key = self._key(labels)
        self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    expose = Counter.expose
    snapshot = Counter.snapshot


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"{self.name}: need at least one bucket")
        self.buckets = bs
        # per label-key: [count per finite bucket] + (sum, count)
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sum: Dict[Tuple[str, ...], float] = {}
        self._n: Dict[Tuple[str, ...], int] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        counts = self._counts.setdefault(key, [0] * len(self.buckets))
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                counts[i] += 1
                break
        self._sum[key] = self._sum.get(key, 0.0) + float(value)
        self._n[key] = self._n.get(key, 0) + 1

    def count(self, **labels) -> int:
        return self._n.get(self._key(labels), 0)

    def sum(self, **labels) -> float:
        return self._sum.get(self._key(labels), 0.0)

    def _cumulative(self, key: Tuple[str, ...]) -> List[int]:
        out, acc = [], 0
        for c in self._counts.get(key, [0] * len(self.buckets)):
            acc += c
            out.append(acc)
        return out

    def expose(self) -> Iterable[str]:
        for key in sorted(self._n):
            cum = self._cumulative(key)
            for ub, c in zip(self.buckets, cum):
                ls = self._label_str_with(key, "le", _fmt(ub))
                yield f"{self.name}_bucket{ls} {c}"
            ls = self._label_str_with(key, "le", "+Inf")
            yield f"{self.name}_bucket{ls} {self._n[key]}"
            yield f"{self.name}_sum{self._label_str(key)} {_fmt(self._sum[key])}"
            yield f"{self.name}_count{self._label_str(key)} {self._n[key]}"

    def _label_str_with(self, key: Tuple[str, ...], extra_k: str,
                        extra_v: str) -> str:
        pairs = [f'{ln}="{_escape(v)}"' for ln, v in zip(self.label_names, key)]
        pairs.append(f'{extra_k}="{extra_v}"')
        return "{" + ",".join(pairs) + "}"

    def snapshot(self) -> List[Dict]:
        out = []
        for key in sorted(self._n):
            cum = self._cumulative(key)
            buckets = {_fmt(ub): c for ub, c in zip(self.buckets, cum)}
            buckets["+Inf"] = self._n[key]
            out.append({"labels": self._label_dict(key), "count": self._n[key],
                        "sum": self._sum[key], "buckets": buckets})
        return out


def _fmt(v: float) -> str:
    """Prometheus-style number formatting: integers without the trailing .0."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class MetricsRegistry:
    """Name -> metric map with idempotent getters: asking for an existing
    (name, kind) returns the same object; a kind clash raises."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_make(self, cls, name: str, help: str, labels: Sequence[str],
                     **kw) -> _Metric:
        cur = self._metrics.get(name)
        if cur is not None:
            if not isinstance(cur, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {cur.kind}"
                )
            if tuple(labels) != cur.label_names:
                raise ValueError(
                    f"metric {name!r} re-registered with labels {tuple(labels)} "
                    f"!= {cur.label_names}"
                )
            return cur
        m = cls(name, help, labels, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(Histogram, name, help, labels, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> List[str]:
        return sorted(self._metrics)

    # -- exposition ---------------------------------------------------------

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m.expose())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict:
        """JSON-able dump of every metric's current state."""
        return {
            name: {
                "type": m.kind,
                "help": m.help,
                "labels": list(m.label_names),
                "values": m.snapshot(),
            }
            for name, m in sorted(self._metrics.items())
        }

    def write_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.snapshot(), fh, indent=2, sort_keys=True)

    def write_prometheus(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_prometheus())


_SAMPLE_RE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$')
_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"(,|$)')


def parse_prometheus(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]:
    """Read text exposition back: ``{(sample name, ((label, value), ...)):
    value}``. Raises ValueError on a malformed line, a sample whose metric
    has no ``# TYPE`` line before it, or a repeated sample."""
    typed: Dict[str, str] = {}
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for n, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or not _NAME_RE.match(parts[2]):
                raise ValueError(f"line {n}: bad TYPE line {line!r}")
            typed[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {n}: bad sample line {line!r}")
        name, labels, value = m.groups()
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in typed and base not in typed:
            raise ValueError(f"line {n}: sample {name} before its TYPE line")
        pairs = []
        if labels:
            body = labels[1:-1]
            pos = 0
            while pos < len(body):
                pm = _PAIR_RE.match(body, pos)
                if pm is None:
                    raise ValueError(f"line {n}: bad labels {labels!r}")
                pairs.append((pm.group(1), pm.group(2)))
                pos = pm.end()
        key = (name, tuple(pairs))
        if key in out:
            raise ValueError(f"line {n}: repeated sample {line!r}")
        out[key] = float(value)
    return out

"""Profiling hooks for the serving loop (port of ``repro/obs/profile.py``).

Two tools, both opt-in and ~free when disabled:

- ``StepTimer`` — a *sampled* per-tick phase timer. Every ``sample_every``-th
  scheduler tick is sampled: each phase (``admit`` / ``decode`` / ``host``)
  is timed with a monotonic host clock, and ``sync(x)`` waits for the
  device inside the phase on sampled ticks only (``torch.cuda.synchronize``
  of the device a CUDA tensor in ``x`` lies on; a no-op for CPU tensors and
  host arrays). The port's decode tick already returns host tokens after
  its one barrier (the ``.tolist()`` in ``serve/scheduler.py``), so a
  sampled ``decode`` phase holds the tick's device time; ``sync`` adds a
  wait only where a caller hands it device tensors. Unsampled ticks pay one
  modulo and a shared null context per phase: no clock read, no
  synchronise, no allocation. Phase totals extrapolate to a whole-run
  breakdown (``summary()``), and sampled phases optionally stream to a
  ``Tracer`` as spans on the ``profiler`` track.
- ``profile_trace(log_dir)`` — a ``torch.profiler.profile`` window (CPU
  activities, and CUDA's when a GPU is present) around a serve drain
  (``--profile-dir`` in launch/serve.py); on exit it writes a Chrome trace
  into ``log_dir`` (its path in ``.path``). A falsy dir gives a null
  context.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import torch

__all__ = ["NULL_TIMER", "NullStepTimer", "StepTimer", "profile_trace"]


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL = _NullCtx()


class _Phase:
    """Times one phase of a sampled tick."""

    __slots__ = ("_timer", "_name", "_t0")

    def __init__(self, timer: "StepTimer", name: str):
        self._timer = timer
        self._name = name

    def __enter__(self):
        self._t0 = self._timer.clock()
        return self

    def __exit__(self, *exc):
        t1 = self._timer.clock()
        self._timer._record(self._name, self._t0, t1)
        return None


def _cuda_device(x) -> Optional[torch.device]:
    """The device of the first CUDA tensor in ``x`` (a tensor or a
    tuple/list of them), else None."""
    if isinstance(x, torch.Tensor):
        return x.device if x.is_cuda else None
    if isinstance(x, (list, tuple)):
        for v in x:
            dev = _cuda_device(v)
            if dev is not None:
                return dev
    return None


class StepTimer:
    """Sampled scheduler-tick phase timer.

    Usage (serve/scheduler.py)::

        prof.tick()                       # decides whether to sample
        with prof.phase("admit"):  ...    # prefill + queue work
        with prof.phase("decode"): prof.sync(step_out)
        with prof.phase("host"):   ...    # emit/EOS bookkeeping
    """

    enabled = True

    def __init__(self, sample_every: int = 16, *, tracer=None,
                 clock: Optional[Callable[[], float]] = None):
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, got {sample_every}")
        self.sample_every = sample_every
        self.tracer = tracer
        # share the tracer clock when there is one, so profiler spans land on
        # the same timeline as the scheduler's request spans
        if clock is None:
            clock = tracer.clock if (tracer is not None and tracer.enabled) \
                else time.perf_counter
        self.clock = clock
        self.ticks = 0
        self.sampled_ticks = 0
        self.sampling = False
        self.phase_s: Dict[str, float] = {}
        self.phase_calls: Dict[str, int] = {}

    def tick(self) -> bool:
        """Advance the tick counter; every ``sample_every``-th tick samples."""
        self.sampling = (self.ticks % self.sample_every) == 0
        self.ticks += 1
        if self.sampling:
            self.sampled_ticks += 1
        return self.sampling

    def phase(self, name: str):
        if not self.sampling:
            return _NULL
        return _Phase(self, name)

    def sync(self, x):
        """Wait for the device inside a sampled phase, so its wall time is
        attributed here; a passthrough when not sampling, and for CPU
        tensors and host arrays."""
        if self.sampling and x is not None:
            dev = _cuda_device(x)
            if dev is not None:
                torch.cuda.synchronize(dev)
        return x

    def _record(self, name: str, t0: float, t1: float) -> None:
        dt = max(t1 - t0, 0.0)
        self.phase_s[name] = self.phase_s.get(name, 0.0) + dt
        self.phase_calls[name] = self.phase_calls.get(name, 0) + 1
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.add_span(name, "profiler", t0, t1, tick=self.ticks - 1)

    def summary(self) -> Dict:
        """Per-phase totals over the sampled ticks + the whole-run
        extrapolation (sampled ticks are an unbiased systematic sample of the
        steady-state loop)."""
        total = sum(self.phase_s.values())
        phases = {
            name: {
                "total_s": self.phase_s[name],
                "calls": self.phase_calls.get(name, 0),
                "mean_s": self.phase_s[name] / max(self.phase_calls.get(name, 1), 1),
                "fraction": (self.phase_s[name] / total) if total > 0 else 0.0,
            }
            for name in sorted(self.phase_s)
        }
        return {
            "ticks": self.ticks,
            "sampled_ticks": self.sampled_ticks,
            "sample_every": self.sample_every,
            "sampled_total_s": total,
            "phases": phases,
        }


class NullStepTimer(StepTimer):
    """Disabled timer: ``tick`` is a no-op and every phase is the shared null
    context — the scheduler's hot loop pays two attribute lookups per tick."""

    enabled = False

    def __init__(self):
        super().__init__(sample_every=1)
        self.sampling = False

    def tick(self) -> bool:
        return False

    def phase(self, name: str):
        return _NULL

    def sync(self, x):
        return x


NULL_TIMER = NullStepTimer()


class _ProfileWindow:
    """A ``torch.profiler.profile`` window that writes its Chrome trace into
    ``log_dir`` on exit; ``path`` names the file."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path: Optional[str] = None
        self.prof = None

    def __enter__(self) -> "_ProfileWindow":
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.log_dir, exist_ok=True)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.prof.__exit__(*exc)
        fd, self.path = tempfile.mkstemp(prefix="serve_", suffix=".pt.trace.json",
                                         dir=self.log_dir)
        os.close(fd)
        self.prof.export_chrome_trace(self.path)
        return None


def profile_trace(log_dir: Optional[str]):
    """A torch.profiler window for a serve drain (``--profile-dir``) that
    writes a Chrome trace into ``log_dir``; a falsy dir -> null context."""
    if not log_dir:
        return contextlib.nullcontext()
    return _ProfileWindow(log_dir)

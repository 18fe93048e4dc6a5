"""Wall-clock phase timers for the epoch loop, and the port's tracer.

Counterpart of gppvae_tpu/utils/timers.py: phases A/B/C of the GPPVAE epoch
are timed individually, and sec/epoch is their sum. CUDA work is
asynchronous, so each phase starts and ends with a device synchronize (the
JAX package blocks on its results at the phase boundaries): the numbers mean
device time, not enqueue time. On the CPU the synchronize is a no-op.

The tracer is one per process (`TRACER`; the module-level `span`, `count`,
`read`, `set_tracing`, `take` are its methods):

  span(name)     a context manager around a piece of work. While tracing is
                 on it records (name, parent, start, end) on
                 time.perf_counter_ns() in a bounded list, the innermost
                 open span being the parent; while a torch.profiler records
                 too, it also enters torch.profiler.record_function(name),
                 so the span is a `user_annotation` of the profiler's trace,
                 on the clock of the device's kernels. Off, it returns one
                 shared null context and reads no clock.
  count(name)    a counter, always kept (the kernels' launch counts live
                 here); while a span is open, the increment is also
                 credited to the innermost one.
  tally()        a context manager that holds the counts made inside it
                 back from the counters and the spans and yields them as a
                 dict: work recorded once and run many times (a captured
                 CUDA graph) credits them again on each run.
  read(site, convert, value)
                 convert(value) where the host waits for the device: a read
                 of a device value (`bool`, `float`, `torch.Tensor.tolist`)
                 or a blocking copy of a number onto it. Counted as
                 `host_sync`, and while tracing is on recorded as the leaf
                 span `sync.<site>`.

Tracing is on while `set_tracing(True)` holds (`--profile_dir` sets it), and
while a torch.profiler records: the benchmark's traced slices read the spans
they recorded. A span enters record_function only where both hold, since a
profiler that records the card's activity alone prices it at ~16 µs against
~1.5 µs for the record (one H100's host). `take()` hands over the recorded
spans, with the counts credited to each, and clears them.
"""

from __future__ import annotations

import collections.abc
import contextlib
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_LIMIT = 1 << 16  # spans kept until the next take(); later ones are dropped


def _profiling() -> bool:
    """Whether a torch.profiler records in this process."""
    return _autograd_profiler._is_profiler_enabled


class Span(NamedTuple):
    """One recorded span: `parent` is the index of the enclosing span in
    the same list (-1 for a root), times in perf_counter nanoseconds,
    `counts` the counters credited while it was the innermost open span."""

    name: str
    parent: int
    start_ns: int
    end_ns: int
    counts: dict


def self_ns(spans: list[Span]) -> list[int]:
    """Each span's own nanoseconds: its length less its children's."""
    out = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


class _Open:
    """An open span: its record, and the profiler's range while tracing is
    on and a profiler records."""

    __slots__ = ("tracer", "name", "index", "annotation")

    def __init__(self, tracer: Tracer, name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        t = self.tracer
        self.annotation = None
        if t.on and _profiling():
            self.annotation = _autograd_profiler.record_function(self.name)
            self.annotation.__enter__()
        self.index = len(t.spans)
        if self.index < t.limit:
            t.spans.append([self.name, t.stack[-1] if t.stack else -1,
                            time.perf_counter_ns(), 0, None])
            t.stack.append(self.index)
        else:
            self.index = None
            t.dropped += 1
        return self

    def __exit__(self, *exc):
        t = self.tracer
        if self.index is not None:
            t.spans[self.index][3] = time.perf_counter_ns()
            t.stack.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


_NULL = contextlib.nullcontext()


class Tracer:
    """Spans and counters of one process (see the module docstring)."""

    def __init__(self, limit: int = SPAN_LIMIT):
        self.on = False
        self.limit = limit
        self.counts: dict[str, int] = {}
        self.spans: list[list] = []  # [name, parent, start_ns, end_ns, counts | None]
        self.stack: list[int] = []  # the open recorded spans, innermost last
        self.dropped = 0  # spans not recorded because the list was full
        self.held: dict | None = None  # the counts of an open tally()

    def set_tracing(self, on: bool) -> None:
        self.on = bool(on)

    def span(self, name: str):
        if not (self.on or _profiling()):
            return _NULL
        return _Open(self, name)

    def count(self, name: str, n: int = 1) -> None:
        if self.held is not None:
            self.held[name] = self.held.get(name, 0) + n
            return
        self.counts[name] = self.counts.get(name, 0) + n
        if self.stack:
            rec = self.spans[self.stack[-1]]
            if rec[4] is None:
                rec[4] = {}
            rec[4][name] = rec[4].get(name, 0) + n

    @contextlib.contextmanager
    def tally(self):
        outer, self.held = self.held, {}
        try:
            yield self.held
        finally:
            self.held = outer

    def read(self, site: str, convert, value):
        if not (self.on or _profiling()):
            self.count("host_sync")
            return convert(value)
        with _Open(self, "sync." + site):
            self.count("host_sync")
            return convert(value)

    def take(self) -> list[Span]:
        """The recorded spans, oldest first, and clear them (none may be open)."""
        if self.stack:
            raise RuntimeError(f"take() with {len(self.stack)} span(s) open")
        out = [Span(n, p, a, b, c or {}) for n, p, a, b, c in self.spans]
        self.spans, self.dropped = [], 0
        return out


class Counters(collections.abc.MutableMapping):
    """The counters `<prefix>.<key>` of a tracer for the given keys, as a dict
    of ints (nll_core's launches per driver)."""

    def __init__(self, tracer: Tracer, prefix: str, keys):
        self.tracer, self.prefix, self.names = tracer, prefix, tuple(keys)

    def __getitem__(self, key):
        if key not in self.names:
            raise KeyError(key)
        return self.tracer.counts.get(f"{self.prefix}.{key}", 0)

    def __setitem__(self, key, value):
        if key not in self.names:
            raise KeyError(key)
        self.tracer.counts[f"{self.prefix}.{key}"] = value

    def __delitem__(self, key):
        raise TypeError("a counter cannot be deleted")

    def __iter__(self):
        return iter(self.names)

    def __len__(self):
        return len(self.names)


TRACER = Tracer()
span, count, read, tally = TRACER.span, TRACER.count, TRACER.read, TRACER.tally
set_tracing, take = TRACER.set_tracing, TRACER.take


class PhaseTimer:
    """Seconds per named phase, accumulated in `totals` until `reset`; each
    phase is also a span of the same name."""

    def __init__(self, device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self.totals: dict[str, float] = {}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        try:
            with span(name):
                try:
                    yield
                finally:
                    self.sync()
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def reset(self) -> dict[str, float]:
        out, self.totals = self.totals, {}
        return out

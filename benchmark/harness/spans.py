"""The program's own spans and counters, as the per-layer readers read them.

The program's tracer (gppvae_tpu_torch/utils/timers.py) records a span for
each piece of work it names while tracing is on, and tracing is on while a
torch.profiler records. So a traced run holds the spans of its two profiled
slices, in order: the card-only slice (`run.slice`: `units` epochs or
requests), then the host slice (`run.host_slice`). The readers read the
card-only slice's, whose host work the profiler slows least.

A program without the tracer (any version before it) gives no spans, and
every reader of this module reads None there.

`idle_by_span` gives each stretch in which the card ran nothing to the
program span that covers most of it, in a profiler trace that holds the
spans as user annotations (the host's and the card's activity recorded
together): what the program was doing while the card waited.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import time
import weakref

import torch

from benchmark.harness.trace import DEVICE_CATS

_TAKEN: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from gppvae_tpu_torch.utils import timers
    except ImportError:
        return None
    return timers if hasattr(timers, "take") and hasattr(timers, "self_ns") else None


def set_tracing(on: bool) -> None:
    """Turn the program's tracing on or off; nothing where it has no tracer."""
    timers = tracer()
    if timers is not None:
        timers.set_tracing(on)


def taken(run) -> list | None:
    """Every span the program recorded until the run's readers ran (taken
    from the tracer once per run), or None where it has no tracer."""
    if run not in _TAKEN:
        timers = tracer()
        _TAKEN[run] = None if timers is None else timers.take()
    return _TAKEN[run]


def slice_roots(run, root: str) -> tuple[list, list[int]] | None:
    """(spans, the indices of the card-only slice's root spans named
    `root`): of the last roots of that name, one per unit of both slices,
    the card-only slice's; None where they are not all there."""
    spans = taken(run)
    if not spans or run.slice is None:
        return None
    first, host = run.slice.units, run.host_slice.units if run.host_slice else 0
    roots = [i for i, s in enumerate(spans) if s.parent == -1 and s.name == root]
    if first < 1 or len(roots) < first + host:
        return None
    return spans, roots[len(roots) - first - host:len(roots) - host]


def subtrees(spans: list, roots: list[int]) -> list[list[int]]:
    """The indices of each root's span and every span below it."""
    children = collections.defaultdict(list)
    for i, s in enumerate(spans):
        children[s.parent].append(i)
    out = []
    for r in roots:
        tree, todo = [], [r]
        while todo:
            k = todo.pop()
            tree.append(k)
            todo += children[k]
        out.append(tree)
    return out


def steps(run) -> tuple[list, list[list[int]]] | None:
    """(spans, each Phase C step's subtree) of the card-only slice's epochs."""
    found = slice_roots(run, "C_minibatch")
    if found is None:
        return None
    spans, roots = found
    trees = subtrees(spans, roots)
    step_roots = [i for tree in trees for i in tree if spans[i].name == "C.step"]
    return (spans, subtrees(spans, step_roots)) if step_roots else None


def ms_per_step(run, match) -> float | None:
    """Milliseconds per Phase C step in the spans under C.step whose name
    `match(name)` accepts, each whole."""
    found = steps(run)
    if found is None:
        return None
    spans, trees = found
    total = sum(spans[i].end_ns - spans[i].start_ns
                for tree in trees for i in tree if match(spans[i].name))
    return 1e-6 * total / len(trees)


def count_per_step(run, counter: str) -> float | None:
    """The counter's increments credited under C.step, per step."""
    found = steps(run)
    if found is None:
        return None
    spans, trees = found
    return sum(spans[i].counts.get(counter, 0) for tree in trees for i in tree) / len(trees)


def ms_per_request(run, name: str) -> float | None:
    """Mean milliseconds of the span `name` under each request's
    serve.predict in the card-only slice."""
    found = slice_roots(run, "serve.predict")
    if found is None:
        return None
    spans, roots = found
    total = sum(spans[i].end_ns - spans[i].start_ns for tree in subtrees(spans, roots)
                for i in tree if spans[i].name == name)
    return 1e-6 * total / len(roots)


def ms_between_requests(run) -> float | None:
    """Mean milliseconds from the end of one request's serve.predict to the
    start of the next in the card-only slice: the wait for the card and the
    copy back to the host, and the next request's indices sent to the card."""
    found = slice_roots(run, "serve.predict")
    if found is None or len(found[1]) < 2:
        return None
    spans, roots = found
    gaps = [spans[b].start_ns - spans[a].end_ns for a, b in zip(roots, roots[1:])]
    return 1e-6 * sum(gaps) / len(gaps)


# -- a trace with the program's spans

class Recording:
    """torch.profiler with the host's and the card's activity, started and
    stopped by the caller; stop() gives the trace's events and the wall
    seconds between."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        self.device, self.cuda = device, device.type == "cuda"
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        *([ProfilerActivity.CUDA] if self.cuda else [])])
        self.t0 = None

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> tuple[list, float]:
        self._sync()
        wall = time.perf_counter() - self.t0
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"], wall
        finally:
            os.remove(path)


def idle_by_span(events: list, wall_s: float, names=None, top: int = 10) -> dict:
    """The card's idle seconds in a trace by program span: each idle
    stretch goes to the innermost span that covers more than half of it, or
    where none does, to the span that covers most of it; a stretch that no
    span touches is "outside the program". `names`: the program's span
    names, where the trace holds other annotations too (torch.optim's
    `Optimizer.step#...`). {"idle_s", "under_spans_s", "spans": [[name,
    seconds]]}."""
    timed = [e for e in events if "dur" in e]
    dev = [e for e in timed if e.get("cat") in DEVICE_CATS]
    marks = [e for e in timed if e.get("cat") == "user_annotation"
             and (names is None or e["name"] in names)]
    t0 = min((e["ts"] for e in timed if e.get("cat") in (*DEVICE_CATS, "cpu_op")), default=0.0)
    span = lambda e: ((e["ts"] - t0) / 1e6, (e["ts"] + e["dur"] - t0) / 1e6)  # noqa: E731
    busy = sorted(span(e) for e in dev)
    marks = sorted((*span(e), e["name"]) for e in marks)
    gaps, end = [], 0.0
    for a, b in busy:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if wall_s > end:
        gaps.append((end, wall_s))
    idle = collections.Counter()
    for ga, gb in gaps:
        most, inner = (0.0, "outside the program"), None
        for a, b, n in marks:
            if a >= gb:
                break
            cover = min(gb, b) - max(ga, a)
            if cover > (gb - ga) / 2 and (inner is None or b - a < inner[0]):
                inner = (b - a, n)
            elif cover > most[0]:
                most = (cover, n)
        idle[(inner or most)[1]] += gb - ga
    total = sum(idle.values())
    return {"idle_s": total, "under_spans_s": total - idle["outside the program"],
            "spans": [[k, v] for k, v in idle.most_common(top)]}

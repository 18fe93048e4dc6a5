#!/usr/bin/env python3
"""Split one cell's work by the program's own spans, on one card.

    python3 benchmark/split.py --workload <cell> --seed <n> [--units 3] [--out FILE]

Sets the cell up as benchmark/run.py does, with the program's tracer on
through set-up (the spans `setup` or `fold` and their parts), warms it, then
runs its units of work (epochs, or blocks of the mix's `trace_requests`
requests) with tracing off and on in turns, `--units` of each: the cost of
tracing, and from the traced units the program's split of a Phase C step or a
request. Then one more unit under torch.profiler with the host's and the
card's activity gives the card's idle time by the program span that covers it
(harness/spans.py idle_by_span), and one more epoch, or one predict_images
call and one request, under CUDA's sync debug mode gives the synchronising
calls it warns about by place, and for the epoch's first step or the call
their number against the program's `host_sync` count.

Its last line on standard output is one JSON object, also written to --out.
Nothing here is compared or judged: it is the measurement behind the
per-layer metrics that read the program's spans, with the sums that must
agree. Without a CUDA card it exits 2, unless --device cpu (for the tests:
no device number means anything there).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness import spans  # noqa: E402

SPANS_PER_PROBE = 50_000  # spans opened and closed to price one, each way


def _ms(ns: int) -> float:
    return ns / 1e6


def span_cost_ns(timers, device) -> dict:
    """Nanoseconds to open and close one span on a tracer of its own:
    tracing off, on, and off under a torch.profiler that records the card's
    activity alone, as the benchmark's card-only slice does (the span then
    records, as with tracing on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def probe(t) -> float:
        t0 = time.perf_counter_ns()
        for _ in range(SPANS_PER_PROBE):
            with t.span("probe"):
                pass
        return (time.perf_counter_ns() - t0) / SPANS_PER_PROBE

    out = {}
    for on in (False, True):
        t = timers.Tracer(limit=SPANS_PER_PROBE)
        t.set_tracing(on)
        out["on" if on else "off"] = probe(t)
    acts = [ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU]
    with profile(activities=acts):
        out["card_profiler"] = probe(timers.Tracer(limit=SPANS_PER_PROBE))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return out


class SyncWatch:
    """CUDA's sync debug mode at "warn" between start() and stop(), its
    warnings kept: `mark()` is (synchronising calls warned about, the
    program's host_sync count) so far, and stop() gives the count of each
    place ("file:line") that made one. Off the card it watches nothing."""

    def __init__(self, device, timers):
        self.cuda, self.timers = device.type == "cuda", timers
        self.caught = self._catch = None

    def start(self) -> None:
        if not self.cuda:
            return
        import torch

        # set before the warnings are caught: the first switch of a process
        # warns once itself (torch/cuda/__init__.py's set_sync_debug_mode)
        torch.cuda.set_sync_debug_mode("warn")
        self._catch = warnings.catch_warnings(record=True)
        self.caught = self._catch.__enter__()
        warnings.simplefilter("always")

    def _sites(self) -> list[str]:
        return [f"{w.filename}:{w.lineno}" for w in self.caught
                if "synchroniz" in str(w.message)]

    def mark(self) -> tuple[int, int] | None:
        if not self.cuda:
            return None
        return len(self._sites()), self.timers.TRACER.counts.get("host_sync", 0)

    def stop(self) -> dict | None:
        if not self.cuda:
            return None
        import torch

        torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(None, None, None)
        return dict(collections.Counter(self._sites()).most_common())


def watched(fn, watch: SyncWatch) -> dict | None:
    """fn() between two marks: {"warned", "host_sync"} over the call alone."""
    a = watch.mark()
    fn()
    b = watch.mark()
    return None if a is None else {"warned": b[0] - a[0], "host_sync": b[1] - a[1]}


def step_split(found, timers) -> dict:
    """Per Phase C step: the dispatch spans' own ms, the sync spans' ms, the
    step's, and what of the step no child holds."""
    own = timers.self_ns(found)
    steps = [i for i, s in enumerate(found) if s.name == "C.step"]
    rows = []
    for tree in spans.subtrees(found, steps):
        row = {"C.forward": 0, "C.backward": 0, "C.optim": 0, "sync": 0, "host_sync": 0}
        for i in tree:
            s = found[i]
            if s.name in row:
                row[s.name] += own[i]
            elif s.name.startswith("sync."):
                row["sync"] += s.end_ns - s.start_ns
            row["host_sync"] += s.counts.get("host_sync", 0)
        step = found[tree[0]]
        row["C.step"] = step.end_ns - step.start_ns
        row["step_own"] = own[tree[0]]
        rows.append(row)
    mean = {k: statistics.fmean(r[k] for r in rows) for k in rows[0]}
    return {"steps": len(rows),
            **{f"{k}_ms": _ms(mean[k]) for k in ("C.forward", "C.backward", "C.optim", "sync",
                                                 "C.step", "step_own")},
            "host_syncs_per_step": mean["host_sync"],
            "step_own_share_max": max(r["step_own"] / r["C.step"] for r in rows),
            "step_sum_ms": _ms(sum(r["C.step"] for r in rows))}


def setup_split(found, names) -> dict:
    """Seconds of each span whose name is in `names`, or begins with one of
    them and a dot, summed by name."""
    out: dict[str, float] = {}
    for s in found:
        if s.name in names or s.name.split(".")[0] in names:
            out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
    return out


class _Train:
    """The training cell's course, one step per epoch record: set-up's
    spans at the checked epoch's record; warm epochs; units untraced and
    traced in turns; one epoch under the profiler; one epoch whose first
    step runs under the sync debug mode; then WindowClosed."""

    def __init__(self, trainer, mix, units, device, timers, t_inputs):
        self.trainer, self.mix, self.device = trainer, mix, device
        self.timers, self.t_inputs = timers, t_inputs
        self.last = self.recording = self.watch = None
        self.plan = ["off", "on"] * units + ["profile", "sync"]
        self.out: dict = {"epochs": {"off": [], "on": []}}

    def __call__(self, record) -> None:
        from benchmark.harness import program

        now, epoch, timers = time.perf_counter(), record["epoch"], self.timers
        if epoch == 0:
            timers.set_tracing(False)
            setup = setup_split(timers.take(), ("setup", "kernels"))
            self.out["setup"] = setup
            self.out["program_part_s"] = self.trainer.built_at - self.t_inputs
            self.out["setup_over_program_part"] = setup["setup"] / self.out["program_part_s"]
        if epoch < self.mix["warm_epochs"] - 1:
            return
        done = epoch - (self.mix["warm_epochs"] - 1)  # units of the plan finished
        if done > 0:
            kind = self.plan[done - 1]
            wall = now - self.last
            if kind in ("off", "on"):
                self.out["epochs"][kind].append(wall)
            if kind == "on":
                timers.set_tracing(False)
                found = timers.take()
                split = step_split(found, timers)
                split["C_minibatch_s"] = record["sec_C_minibatch"]
                split["steps_over_phase"] = split["step_sum_ms"] / 1e3 / split["C_minibatch_s"]
                split["spans"] = len(found)
                self.out.setdefault("traced", []).append(split)
            elif kind == "profile":
                events, wall_s = self.recording.stop()
                timers.set_tracing(False)
                names = {s.name for s in timers.take()}
                self.out["idle"] = spans.idle_by_span(events, wall_s, names)
            elif kind == "sync":
                self.out["sync_epoch"] = self.watch.stop()
        if done == len(self.plan):
            raise program.WindowClosed
        kind = self.plan[done]
        if kind == "on":
            timers.set_tracing(True)
        elif kind == "profile":
            timers.set_tracing(True)
            self.recording = spans.Recording(self.device)
            self.recording.start()
        elif kind == "sync":
            self._watch_epoch()
        self.last = time.perf_counter()

    def _watch_epoch(self) -> None:
        """The next epoch under the sync watch, its first step on its own."""
        loop = self.trainer.loop
        step = loop.minibatch_step
        self.watch = SyncWatch(self.device, self.timers)

        def checked(*args):
            loop.minibatch_step = step
            result = {}
            self.out["sync_step"] = watched(lambda: result.setdefault("m", step(*args)),
                                            self.watch)
            return result["m"]

        loop.minibatch_step = checked
        self.watch.start()


def train(cfg, mix, seed, device, units, timers) -> dict:
    from benchmark.harness import cells, program, traffic

    grid, vae0, gp0, ds, config = cells.inputs(cfg, mix, seed, device)
    t_inputs = time.perf_counter()
    trainer = program.Trainer(ds, config, vae0, gp0, device, mix["checked_steps"])
    course = _Train(trainer, mix, units, device, timers, t_inputs)
    timers.set_tracing(True)
    try:
        trainer.run(traffic.epoch_draws(seed, len(ds.train_idx), config.batch_size,
                                        config.zdim), course)
    finally:
        timers.set_tracing(False)
    out = course.out
    off, on = statistics.median(out["epochs"]["off"]), statistics.median(out["epochs"]["on"])
    spans_per_epoch = statistics.fmean(t["spans"] for t in out["traced"])
    out["cost"] = {"epoch_off_s": off, "epoch_on_s": on, "on_over_off": on / off,
                   "spans_per_epoch": spans_per_epoch}
    return out


def serve(cfg, mix, seed, device, units, timers) -> dict:
    import torch

    from benchmark.harness import cells, program, traffic

    grid, vae0, gp0, ds, config = cells.inputs(cfg, mix, seed, device)
    t_inputs = time.perf_counter()
    timers.set_tracing(True)
    server = program.Server(ds, config, cfg["model"], vae0, gp0, device)
    timers.set_tracing(False)
    out: dict = {"program_part_s": time.perf_counter() - t_inputs}
    out["setup"] = setup_split(timers.take(), ("fold",))
    out["fold_over_program_part"] = out["setup"]["fold"] / out["program_part_s"]
    reqs = traffic.Requests(mix, seed, ds.num_objects, ds.num_views)
    for d, q in reqs.warm_sizes():
        server.request(d, q)
    n = mix["trace_requests"]
    lat: dict = {"off": [], "on": []}
    block_s = {"off": 0.0, "on": 0.0}
    rows, n_spans = [], 0
    for kind in ["off", "on"] * units:
        block = [reqs.next()[:2] for _ in range(n)]
        timers.set_tracing(kind == "on")
        ends = []
        t_block = time.perf_counter()
        for d, q in block:
            a = time.perf_counter_ns()
            server.request(d, q)
            ends.append(time.perf_counter_ns())
            lat[kind].append(ends[-1] - a)
        block_s[kind] += time.perf_counter() - t_block
        timers.set_tracing(False)
        if kind == "on":
            found = timers.take()
            n_spans += len(found)
            roots = [i for i, s in enumerate(found) if s.name == "serve.predict"]
            for r, tree, end in zip(roots, spans.subtrees(found, roots), ends):
                by = {found[i].name: found[i].end_ns - found[i].start_ns for i in tree}
                rows.append({"predict": by["serve.predict"], "gp": by["serve.gp"],
                             "decode": by["serve.decode"], "wait": end - found[r].end_ns,
                             "request": lat["on"][len(rows)]})
    out["traced"] = {f"{k}_ms": _ms(statistics.fmean(r[k] for r in rows)) for k in rows[0]}
    out["traced"]["requests"] = len(rows)
    out["cost"] = {"request_off_ms": _ms(statistics.median(lat["off"])),
                   "request_on_ms": _ms(statistics.median(lat["on"])),
                   "on_over_off": block_s["on"] / block_s["off"],
                   "spans_per_request": n_spans / len(rows)}
    block = [reqs.next()[:2] for _ in range(max(1, n // 4))]
    timers.set_tracing(True)
    rec = spans.Recording(device)
    rec.start()
    for d, q in block:
        server.request(d, q)
    events, wall = rec.stop()
    timers.set_tracing(False)
    out["idle"] = spans.idle_by_span(events, wall, {s.name for s in timers.take()})
    d, q = (torch.as_tensor(a, dtype=torch.int64, device=device) for a in reqs.next()[:2])
    watch = SyncWatch(device, timers)
    watch.start()
    out["sync_step"] = watched(
        lambda: program.predict_images(server.model, server.state, d, q), watch)
    out["sync_request"] = watched(lambda: server.request(*reqs.next()[:2]), watch)
    out["sync_sites"] = watch.stop()
    return out


def main(argv=None, manifest=None) -> int:
    """`manifest`: another Manifest than BENCHMARK.json's (the tests' tiny tree)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--units", type=int, default=3,
                   help="units of work untraced and as many traced, in turns")
    p.add_argument("--device", default="cuda", help="cpu: for the tests")
    p.add_argument("--out", default=None, help="also write the JSON object here")
    args = p.parse_args(argv)

    import torch

    from benchmark.harness.manifest import Manifest

    timers = spans.tracer()
    if timers is None:
        print("benchmark: the program has no tracer", file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("benchmark: split.py needs a CUDA card (or --device cpu)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    manifest = manifest or Manifest()
    cell = manifest.workload(args.workload)
    cfg, mix = manifest.config(cell["config"]), manifest.traffic(cell["traffic"])
    kind = {"train": train, "serve": serve}[mix["kind"]]
    timers.take()
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           **kind(cfg, mix, args.seed, device, args.units, timers),
           "process_s": time.perf_counter() - T_START}
    out["span_cost_ns"] = span_cost_ns(timers, device)  # after the cell: its set-up as run.py's
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The traced slices: torch.profiler over fixed pieces of work after the
window, reduced to what the per-layer readers read: one slice of the card's
activity alone, for the device metrics, and a shorter one with the host's
operators too, for the breakdown's idle gaps.

The profiler's chrome trace is written to the run's temporary directory,
read and deleted. From it:

  device   every kernel, copy and set on the card ('kernel', 'gpu_memcpy',
           'gpu_memset' events): their union is the busy time, so kernels
           that overlap count once;
  host     the host's operators ('cpu_op'), to say what the host was doing
           in each stretch where the card had nothing to do.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Slice:
    """One profiled stretch of work: intervals in seconds from its start."""

    def __init__(self, events: list, wall_s: float, units: int):
        self.wall_s, self.units = wall_s, units
        dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        host = [e for e in events if e.get("cat") == "cpu_op" and "dur" in e]
        t0 = min((e["ts"] for e in dev + host), default=0.0)
        self.device = sorted(((e["ts"] - t0) / 1e6, (e["ts"] + e["dur"] - t0) / 1e6,
                              e.get("name", "?")) for e in dev)
        self.host = sorted(((e["ts"] - t0) / 1e6, (e["ts"] + e["dur"] - t0) / 1e6,
                            e.get("name", "?")) for e in host)

    def kernels(self, pattern: str) -> list[float]:
        """Durations (s) of the kernels whose name holds `pattern`."""
        return [b - a for a, b, name in self.device if pattern in name]

    def busy_s(self) -> float:
        """Seconds in which some kernel, copy or set ran (their union)."""
        total, end = 0.0, float("-inf")
        for a, b, _ in self.device:
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    def gaps(self) -> list[tuple[float, float]]:
        """The stretches between device work, within the slice."""
        out, end = [], 0.0
        for a, b, _ in self.device:
            if a > end:
                out.append((end, a))
            end = max(end, b)
        if self.wall_s > end:
            out.append((end, self.wall_s))
        return out

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time: [[name, seconds]]."""
        ops = collections.Counter()
        for a, b, name in self.device:
            ops[name[:160]] += b - a
        return [[k, v] for k, v in ops.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """The card's idle time by the host operator that covered most of
        each gap: [[name, seconds]]."""
        idle = collections.Counter()
        host, i = self.host, 0
        for ga, gb in self.gaps():
            while i < len(host) and host[i][1] <= ga:
                i += 1
            best, name, j = 0.0, "host: no operator", i
            while j < len(host) and host[j][0] < gb:
                cover = min(gb, host[j][1]) - max(ga, host[j][0])
                if cover > best:
                    best, name = cover, host[j][2]
                j += 1
            idle[name[:160]] += gb - ga
        return [[k, v] for k, v in idle.most_common(top)]


class Recorder:
    """torch.profiler, started and stopped by the caller: a slice that
    spans calls the benchmark does not own (the trainer's epochs, from one
    of its log records to another). The card's activity alone by default:
    recording every host operator slows a host-bound loop by half again,
    and with it the card's idle share. `host` records the host's operators
    too, for the breakdown's idle gaps (on the CPU the host's activity is
    all there is)."""

    def __init__(self, device: torch.device, host: bool = False):
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        self.device = device
        self.cuda = device.type == "cuda"
        acts = [ProfilerActivity.CUDA] if self.cuda else []
        if host or not self.cuda:
            acts.append(ProfilerActivity.CPU)
        self.prof = torch_profile(activities=acts)
        self.t0 = None

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self, units: int) -> Slice:
        """The slice since start(), of `units` pieces of work."""
        self._sync()
        wall = time.perf_counter() - self.t0
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return Slice(events, wall, units)


def profile(work, units: int, device: torch.device, host: bool = False) -> Slice:
    """Run `work()` under a Recorder and read it."""
    rec = Recorder(device, host)
    rec.start()
    work()
    return rec.stop(units)

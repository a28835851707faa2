"""The profiler's record of the measured window, reduced to plain intervals.

A ``Trace`` holds, in microseconds on the profiler's one clock, the window
(the benchmark's ``portbench.window`` span), every device activity (kernels,
copies, sets) and the host events of the thread that ran the window.  The
per-layer metrics read it; a recorded one is a JSON fixture of the same
fields.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

WINDOW = "portbench.window"
SPANS = "portbench."   # the benchmark's own spans


@dataclasses.dataclass
class Trace:
    w0: float
    w1: float
    device: list   # [name, start, end]
    host: list     # [name, start, end], the window's thread

    @classmethod
    def from_json(cls, obj: dict) -> "Trace":
        return cls(obj["w0"], obj["w1"], [list(e) for e in obj["device"]],
                   [list(e) for e in obj["host"]])

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e6

    def in_window(self) -> list:
        """Device activities clipped to the window."""
        return [[n, max(s, self.w0), min(e, self.w1)] for n, s, e in self.device
                if e > self.w0 and s < self.w1]

    def device_s(self, keep=lambda name: True) -> float:
        """Summed seconds of the window's device activities that ``keep``."""
        return sum(e - s for n, s, e in self.in_window() if keep(n)) / 1e6

    def busy(self) -> list:
        """The union of the window's device activities, as disjoint
        [start, end] intervals."""
        out: list = []
        for _, s, e in sorted(self.in_window(), key=lambda x: x[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def idle(self) -> list:
        """The window's idle intervals: gaps between busy ones and at its
        ends."""
        gaps, t = [], self.w0
        for s, e in self.busy():
            if s > t:
                gaps.append([t, s])
            t = max(t, e)
        if self.w1 > t:
            gaps.append([t, self.w1])
        return gaps

    def host_at(self, times: list) -> list:
        """The innermost host event running at each of ``times`` (sorted),
        or "(no host event)"."""
        events = sorted(self.host, key=lambda x: (x[1], -x[2]))
        starts = [s for _, s, _ in events]
        out, stack, i = [], [], 0
        for t in times:
            j = bisect.bisect_right(starts, t)
            for name, s, e in events[i:j]:
                while stack and stack[-1][1] <= s:
                    stack.pop()
                stack.append((name, e))
            i = max(i, j)
            while stack and stack[-1][1] <= t:
                stack.pop()
            out.append(stack[-1][0] if stack else "(no host event)")
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, and the idle time
        by the host event that ran in it, each as [name, seconds]."""
        ops: dict = defaultdict(float)
        for n, s, e in self.in_window():
            ops[n] += (e - s) / 1e6
        gaps = self.idle()
        names = self.host_at([(s + e) / 2 for s, e in gaps])
        idle: dict = defaultdict(float)
        for name, (s, e) in zip(names, gaps):
            idle[name] += (e - s) / 1e6
        def best(d):
            return [[n[:160], v] for n, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(ops), "idle_gaps": best(idle)}


def from_profiler(prof) -> Trace:
    """A ``Trace`` from a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            if (getattr(ev, "is_user_annotation", False)
                    or ev.name.startswith((SPANS, "Activity Buffer"))):
                continue  # span annotations and the profiler's own buffers
            device.append([ev.name, s, e])
        elif ev.device_type == DeviceType.CPU:
            host.append([ev.name, s, e, ev.thread])
            if ev.name == WINDOW:
                window = (s, e, ev.thread)
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW!r} span")
    w0, w1, tid = window
    return Trace(w0, w1, device,
                 [[n, s, e] for n, s, e, t in host if t == tid])

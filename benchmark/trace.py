"""A profiled window on the device and what is read from it.

``profile(fn)`` runs fn under ``torch.profiler`` (CPU and CUDA
activities, kept in memory: nothing is written to disk) and returns a
``Trace``: every device interval (kernels, copies, sets; not the
annotations that mirror host spans) with its name, every host
operation, and the window. The device's busy time is the
union of the device intervals inside the window, so overlapping
operations count once; idle is the rest of the window.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

WINDOW = "bench.window"

# names of the port's kernels (substrings of their symbols), for the
# breakdown and the per-layer readers
KERNEL_GROUPS = (
    ("K1 cell forward", ("LstmForward",)),
    ("K4 cell backward", ("LstmBackward",)),
    ("K5 weight grad", ("dwt_",)),
    ("K3 conv3x3", ("conv_mma_kernel", "conv_fma_kernel",
                    "conv_reduce_kernel")),
    ("K2 mask head", ("mask_head",)),
    ("K6 matcher", ("lap_kernel",)),
    ("K7 warp", ("warp_segment_kernel", "warp_pixel_kernel")),
)


def kernel_group(name: str) -> str:
    for label, keys in KERNEL_GROUPS:
        if any(k in name for k in keys):
            return label
    return name[:100]


@dataclass
class Trace:
    window: Tuple[int, int]                  # ns, host clock of the trace
    device: List[Tuple[int, int, str]]       # (start ns, end ns, name)
    host: List[Tuple[int, int, str]] = field(default_factory=list)

    def busy_s(self) -> float:
        lo, hi = self.window
        merged = union(self.device, lo, hi)
        return sum(e - s for s, e in merged) / 1e9

    def device_seconds(self, keys) -> float:
        """Summed duration of the device intervals whose name holds one of
        keys."""
        return sum(e - s for s, e, n in self.device
                   if any(k in n for k in keys)) / 1e9

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for s, e, name in self.device:
            key = kernel_group(name)
            by[key] = by.get(key, 0.0) + (e - s) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The n longest stretches of the window with nothing on the
        device, each named by the innermost host operation running at its
        middle (under the harness's span that holds it)."""
        lo, hi = self.window
        merged = union(self.device, lo, hi)
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        if not self.host:
            return [["host", (e - s) / 1e9] for s, e in gaps[:n]]
        starts = np.array([h[0] for h in self.host])
        ends = np.array([h[1] for h in self.host])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) // 2
            idx = np.flatnonzero((starts <= mid) & (ends >= mid))
            spans = sorted((ends[i] - starts[i], self.host[i][2])
                           for i in idx)
            outer = [nm for _, nm in spans if nm.startswith("bench.")
                     and nm != WINDOW]
            inner = [nm for _, nm in spans if not nm.startswith("bench.")
                     and not nm.startswith("cuda")]
            label = "/".join(([outer[0]] if outer else [])
                             + ([inner[0]] if inner else [])) or "host"
            out.append([label, (e - s) / 1e9])
        return out


def union(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    """Merged (start, end) of intervals clipped to [lo, hi]."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e, *_ in intervals
                   if e > lo and s < hi)
    merged: List[List[int]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _events(prof):
    """(device, host) event lists from the profiler's results."""
    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        item = (start, start + ev.duration_ns(), ev.name())
        if ev.device_type() != cuda:
            host.append(item)
        # a harness span is mirrored on the device's timeline as an
        # annotation over the work it launched: not device work itself
        elif not (ev.is_user_annotation() or item[2].startswith("bench.")):
            device.append(item)
    return device, host


def profile(fn) -> Trace:
    """Runs fn (which ends with the device idle) in a profiled window."""
    from torch.profiler import ProfilerActivity, record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        if torch.cuda.is_available():
            # the profiler requests its activity buffers at the first
            # device work it sees: let that happen before the window
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        with record_function(WINDOW):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    device, host = _events(prof)
    spans = [h for h in host if h[2] == WINDOW]
    lo, hi = ((spans[0][0], spans[0][1]) if spans
              else (min(h[0] for h in host), max(h[1] for h in host)))
    return Trace((lo, hi), device, [h for h in host if h[2] != WINDOW])

"""Frame profiling helpers (the port's copy of
``superconductor_tpu/utils/profiler.py``): wall-clock scope timing on the
host, and a device trace around a block with ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List


class FrameProfiler:
    """Accumulates named host-side timings; cheap enough to leave on."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name}: {tot * 1e3:.2f} ms total, {tot / n * 1e3:.3f} ms avg x{n}")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace of the block (CPU activity, plus CUDA activity
    when a GPU is present), written to `logdir`/trace.json as a chrome
    trace; yields the profiler (its key_averages() summarise the block)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def frame_capacity_report(state, tri_num_valid: int, bins_num_pairs: int, config) -> List[str]:
    """Overflow diagnostics: capacities are static under jit, so overflows
    silently drop triangles — the host should check these once per scene
    change (the analog of the reference's buffer-growth logs)."""
    warnings = []
    if tri_num_valid > config.t_cap:
        warnings.append(
            f"triangle capacity exceeded: {tri_num_valid} > t_cap={config.t_cap}; "
            "increase RenderConfig.t_cap"
        )
    if bins_num_pairs > config.p_cap:
        warnings.append(
            f"bin pair capacity exceeded: {bins_num_pairs} > p_cap={config.p_cap}; "
            "increase RenderConfig.p_cap"
        )
    return warnings

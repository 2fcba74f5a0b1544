"""Ceiling probes of the card, for rooflines (port of
``superconductor_tpu/utils/roofline.py``).

Measures what the device delivers -- dense bf16 matmul FLOP/s, streaming
memory GB/s, random-row gather rate, and the floor of one dispatch -- so a
pass time can be held against

    pred_ms = max(flops / F_ceiling, bytes / B_ceiling)

with the card's measured ceilings instead of its data-sheet peaks.

Timing: each probe is one chain of launches, dispatched n times back to
back for n in ``ns``; CUDA events on the device's stream bracket the n
dispatches (host clock and a synchronise on the CPU), and the reported
time is the slope of t(n) = fixed + n * per_dispatch, which cancels the
events' and the first launch's fixed cost. The numerators (FLOPs, bytes)
are counted from the probes' shapes: an eager torch program has no
compiler cost analysis, so the reference's ``program_costs`` (XLA's
``cost_analysis``) has no counterpart here.

Probes:
- matmul: chained bf16 n x n ``torch.matmul`` (2 n^3 FLOPs each) -- a
  probe of the card's tensor cores, not a kernel of the renderer;
- stream: a chained elementwise map over an f32 array far above the
  H100's 50 MB L2 (each stage reads and writes the array once);
- gather: chained random-row ``index_select`` from a table above the L2,
  counted in payload bytes (rows x row bytes, read and written) and rows;
- floor: the same slope over a one-element add: the least a dispatch
  costs on the stream.
"""

from __future__ import annotations

import time

import torch

__all__ = ["probe_ceilings", "predict_ms"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dispatch_slope_ms(fn, device, ns=(1, 2, 4), calls=3):
    """Per-dispatch ms of `fn` (one chain of launches) by the
    dispatch-count slope: for each n, the median over `calls` of the time
    of n back-to-back dispatches, then (t(n_last) - t(n_first)) / (n_last -
    n_first). Returns (slope, [slopes between neighbouring n])."""
    device = torch.device(device)
    fn()
    _sync(device)

    def timed(n):
        ts = []
        for _ in range(calls):
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(torch.cuda.current_stream(device))
                for _ in range(n):
                    fn()
                end.record(torch.cuda.current_stream(device))
                end.synchronize()
                ts.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                _sync(device)
                ts.append((time.perf_counter() - t0) * 1e3)
        ts.sort()
        return ts[len(ts) // 2]

    t = [timed(n) for n in ns]
    slope = (t[-1] - t[0]) / (ns[-1] - ns[0])
    checks = [(t[i + 1] - t[i]) / (ns[i + 1] - ns[i]) for i in range(len(ns) - 1)]
    return slope, checks


def _probe(make, device, ns, calls) -> dict:
    """Build one probe on `device`, time its dispatch-count slope ->
    {ms_per_dispatch, check_ms, flops, bytes, tflops, gbps}."""
    fn, flops, bytes_ = make(torch.device(device))
    ms, checks = _dispatch_slope_ms(fn, device, ns=ns, calls=calls)
    return {
        "ms_per_dispatch": ms,
        "check_ms": checks,
        "flops": flops,
        "bytes": bytes_,
        "tflops": flops / (ms * 1e-3) / 1e12 if ms > 0 else None,
        "gbps": bytes_ / (ms * 1e-3) / 1e9 if ms > 0 else None,
    }


def _make_matmul(c=32, n=4096):
    """c chained bf16 n x n products: 2 n^3 FLOPs each; bytes are the two
    operands read and the product written once a product."""

    def make(device):
        g = torch.Generator(device="cpu").manual_seed(0)
        a = torch.randn((n, n), generator=g).to(device, torch.bfloat16)
        b = torch.randn((n, n), generator=g).to(device, torch.bfloat16) / n ** 0.5

        def run():
            x = a
            for _ in range(c):
                x = torch.matmul(x, b)  # sequential: each product needs the last
            return x

        return run, 2.0 * c * n ** 3, 3.0 * c * n * n * 2

    return make


def _make_stream(c=8, m=1 << 26):
    """c chained x * s stages over an (m,) f32 array (256 MB at 2^26): each
    stage one kernel that reads and writes the array."""

    def make(device):
        x0 = torch.ones((m,), dtype=torch.float32, device=device)

        def run():
            x = x0
            for i in range(c):
                x = x * (1.0 + 1e-6 * (i + 1))
            return x

        return run, float(c * m), 2.0 * c * m * 4

    return make


def _make_gather(c=4, rows=1 << 23, width=8, m=1 << 22):
    """c chained index_select of m random rows of `width` f32 from a
    (rows, width) table (256 MB at 2^23 x 8), each into its own buffer;
    payload bytes: m x width x 4, read and written, a gather."""

    def make(device):
        table = torch.ones((rows, width), dtype=torch.float32, device=device)
        g = torch.Generator(device="cpu").manual_seed(2)
        idx = [torch.randint(0, rows, (m,), generator=g).to(device) for _ in range(c)]
        out = [torch.empty((m, width), dtype=torch.float32, device=device) for _ in range(c)]

        def run():
            for i in range(c):
                torch.index_select(table, 0, idx[i], out=out[i])
            return out[-1]

        return run, 0.0, 2.0 * c * m * width * 4

    return make


def _make_floor():
    """One add on a one-element tensor: the dispatch floor."""

    def make(device):
        x = torch.zeros((1,), dtype=torch.float32, device=device)

        def run():
            return x.add_(1.0)

        return run, 1.0, 8.0

    return make


def probe_ceilings(ns=(1, 2, 4), calls=3, device="cuda", sizes=None) -> dict:
    """Measure the device's ceilings -> {"matmul_tflops", "stream_gbps",
    "gather_gbps", "gather_mrows_per_s", "dispatch_floor_ms", "device",
    "probes": {name: {...}}}. `sizes` overrides the probes' sizes (a dict
    of {"matmul": (c, n), "stream": (c, m), "gather": (c, rows, width,
    m)}), for small runs on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_ceilings: no CUDA device")
    sizes = dict(sizes or {})
    sizes.setdefault("matmul", (32, 4096))
    sizes.setdefault("stream", (8, 1 << 26))
    sizes.setdefault("gather", (4, 1 << 23, 8, 1 << 22))
    makes = {
        "matmul": _make_matmul(*sizes["matmul"]),
        "stream": _make_stream(*sizes["stream"]),
        "gather": _make_gather(*sizes["gather"]),
        "floor": _make_floor(),
    }
    probes = {name: _probe(make, device, ns, calls) for name, make in makes.items()}
    c, _rows, _width, m = sizes["gather"]
    g = probes["gather"]
    ms = g["ms_per_dispatch"]
    g["mrows_per_s"] = c * m / (ms * 1e-3) / 1e6 if ms > 0 else None
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {
        "matmul_tflops": probes["matmul"]["tflops"],
        "stream_gbps": probes["stream"]["gbps"],
        "gather_gbps": g["gbps"],
        "gather_mrows_per_s": g["mrows_per_s"],
        "dispatch_floor_ms": probes["floor"]["ms_per_dispatch"],
        "device": name,
        "probes": probes,
    }


def predict_ms(flops, bytes_, ceilings):
    """Roofline prediction band for work of (flops, bytes): optimistic =
    all traffic at streaming bandwidth; pessimistic = all traffic at
    random-gather bandwidth; the compute floor from the matmul ceiling
    applies to both."""
    f = ceilings["matmul_tflops"] * 1e12
    bs = ceilings["stream_gbps"] * 1e9
    bg = ceilings["gather_gbps"] * 1e9
    t_flops = flops / f * 1e3 if f else 0.0
    lo = max(t_flops, bytes_ / bs * 1e3) if bs else t_flops
    hi = max(t_flops, bytes_ / bg * 1e3) if bg else t_flops
    return {"pred_lo_ms": lo, "pred_hi_ms": hi, "pred_flops_ms": t_flops}

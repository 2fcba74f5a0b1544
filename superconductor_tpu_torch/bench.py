"""Benchmark: frames per second at 1920x1080 on one CUDA card.

    python3 -m superconductor_tpu_torch.bench

The port of the JAX system's root ``bench.py`` (``main`` :999). Three
configurations, in its order:

1. **headline** (the primary metric) -- ``scenes.headline_scene``:
   ``tests/fixtures/hero_helmet.glb`` through the full asset pipeline, two
   PBR materials, ambient SH and an IBL sky (``bench.py`` :461).
2. **all_passes** -- ``scenes.all_passes_scene``: every pass on, from the
   repository's own data (``bench.py`` :534 reads sponza_cubes.glb, the bcn
   light volume and noon.ktx2 from outside the repository; the JAX bench
   skips the configuration without them, the port runs the committed-data
   frame instead).
3. **stereo_anim** -- ``scenes.stereo_animated_scene``: two 1080p eyes of
   skinned waving tubes (joint palettes from the FK every frame) and PBR
   spheres (``bench.py`` :887).

Each configuration is loaded, its never-drop capacities fitted
(``render/caps.py`` ``fit_caps``, through a cache under ``build/``), and its
fitted frame rendered once, untimed, with the hand kernels and with every
kernel's plain version (``plain_versions``: the raster, the k-buffer and
the two material samplers): the two must be equal byte for byte, else the line
says ``"correct": false`` and names the configuration, no timed number of it
is printed, and the process exits non-zero once the line is out. Then:

- ``device_frame_ms`` (``value`` = 1e3 / it for the headline): the
  dispatch-count slope of one built frame, replayed n times back to back for
  n in (1, 2, 8) ((1, 4) for stereo) and ended by one synchronise
  (``measure_frame_slope``). The port's frames are host-bound, so on the
  card this is the steady frame period that the host sets, not the device's
  busy time;
- ``device_busy_ms``, ``idle_share``, ``launches_per_frame``: a separate run
  traced with torch.profiler after the timed windows (tracing is off in
  every timed window): the summed device time of a frame's kernels and
  copies, the share of ``device_frame_ms`` the device is idle, and its device
  events (``profile_frame.trace_frames``);
- stereo also ``stereo_anim_dispatch_fps`` (frames with the host build of
  each frame: palette FK, draw build, upload) and ``stereo_anim_dispatch_ms``
  (replays of one built frame), as ``bench.py`` ``_measure`` reports them;
- the card's ceilings (``utils/roofline.py`` ``probe_ceilings``).

What the JAX bench has and this one has not, and why: ``make_unrolled`` and
the unroll slope (``device_delta_ms``; k frame copies in one XLA program:
an eager torch frame is no program to unroll, and the dispatch-count slope
above is what the JAX bench's primary metric already was); the headline
unroll cross-check (``frame_check_ms`` gives the slope's linearity); the
background compile threads (nothing compiles here but the kernels, at their
first use); ``headline_gflops``, ``headline_gbytes``, ``pred_lo_ms`` /
``pred_hi_ms``, ``achieved_gbps``, ``stream_bw_utilization`` and
``frame_vs_roofline_band`` (XLA's ``cost_analysis`` of the compiled frame,
``roofline.program_costs``: an eager torch frame has no compiler cost
analysis to count its FLOPs and bytes).

The line is printed as soon as the primary metric lands and again as each
configuration lands (the last parseable line is the result). Environment:
``SC_BENCH_BUDGET_S`` (default 1000) is the wall-clock budget after which
the remaining configurations are skipped; ``SC_BENCH_DEADLINE_S`` (default
900): if the primary has not landed by then, a line with ``value`` 0.0 and
an ``error`` is printed; ``SC_BENCH_SAVE=frame.png`` writes the headline
frame there and the all-passes one beside it (``_all.png``);
``SC_BENCH_REFIT=1`` ignores the caps cache. Progress lines go to stderr.

Without a CUDA device the bench exits non-zero. ``--device cpu --width W
--height H`` runs the same code on the CPU, with fewer frames a measurement
and the all-passes and stereo scenes cut (``CPU_RUNS``), so that tests can
run it end to end; that line says ``"device": {"platform": "cpu"}`` and its
times are not the card's.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field, replace

import torch

from .ops import raster as raster_mod
from .ops import sample as sample_mod
from .ops.raster_kbuffer import kbuffer_sorted_plain
from .profile_frame import idle_share, trace_frames
from .render import frame as frame_mod
from .render.caps import fit_caps
from .render.frame import render_frame
from .scenes import (
    HERO_GLB,
    STEREO_TINY,
    TERRAIN_GLB,
    all_passes_scene,
    headline_scene,
    stereo_animated_scene,
)
from .utils.image import write_png
from .utils.roofline import probe_ceilings

HEADLINE_METRIC = (
    "steady frame rate {w}x{h} PBR+IBL authored asset (hero_helmet.glb 16k-tri "
    "meshopt+ETC1S-KTX2, 2 PBR materials): 1e3 / the dispatch-count slope of one "
    "built frame, host clock ended by torch.cuda.synchronize; superconductor_tpu_torch "
    "(PyTorch + hand CUDA raster and k-buffer kernels) on one NVIDIA card, named "
    "under device"
)
TIMING = (
    "device_frame_ms: slope over n of n back-to-back replays of one built frame ended "
    "by one synchronise, the steady frame period the host sets (frames are host-bound); "
    "device_busy_ms: summed device time of a frame's kernels and copies in a separate "
    "torch.profiler run; idle_share = 1 - device_busy_ms / device_frame_ms"
)
ALL_PASSES_DESC = (
    "{w}x{h}, dense_terrain.glb (114k-tri meshopt/LOD fixture) + 8 spheres (clip, "
    "blend), 22 grid lines, 16 particles, gradient IBL + ambient SH; clip+blend+lines+"
    "particles. Left out (not in the repository): sponza_cubes.glb, the bcn light "
    "volume, noon.ktx2"
)
STEREO_DESC = (
    "2x{w}x{h} stereo, 6 skinned 8-joint tubes (37k anim tris) + 6 PBR spheres "
    "(93k tris), per-frame FK palettes"
)


@dataclass(frozen=True)
class Runs:
    """How much a measurement runs: the slope's n (stereo's its own), calls
    a point and repeats of the whole set; ``_measure``'s windows; the frames
    of the traced run (0: none); the ceiling probes' sizes; and the scene
    cuts by configuration."""

    ns: tuple = (1, 2, 8)
    stereo_ns: tuple = (1, 4)
    calls: int = 3
    repeats: int = 3
    window: dict = field(default_factory=lambda: dict(
        n=10, windows=2, device_windows=2, device_n=10, warmup=3))
    traced: int = 3
    ceiling_sizes: dict = field(default_factory=lambda: {
        "matmul": (8, 4096), "stream": (8, 1 << 25), "gather": (4, 1 << 22, 8, 1 << 21)})
    cuts: dict = field(default_factory=dict)


# On the card: bench.py's counts; the ceiling probes at about half their
# default sizes (bench.py's quick probes), the arrays still above the 50 MB L2.
CARD_RUNS = Runs()
# On the CPU: the fewest frames that still run every step, and scenes cut so
# that a test can afford them (a frame of the uncut all-passes scene takes
# seconds there).
CPU_RUNS = Runs(
    ns=(1, 2), stereo_ns=(1, 2), calls=1, repeats=1,
    window=dict(n=1, windows=1, device_windows=1, device_n=1, warmup=0), traced=0,
    ceiling_sizes={"matmul": (2, 64), "stream": (3, 1 << 12), "gather": (2, 1 << 10, 8, 1 << 9)},
    cuts={"all_passes": dict(stacks=8, lod_screen_height=32),
          "stereo": {k: v for k, v in STEREO_TINY.items() if k not in ("width", "height")}},
)

# --- Fitted-capacity cache (bench.py :60-121) -------------------------------
# The scenes are deterministic, so their fitted caps are too; a hit skips
# fit_caps' stats frames. The key holds what the caps depend on: the scene's
# tag, size and cuts, the bytes of its fixture and of the modules that build
# and render it, and the kernels' cluster constants. The file lives under
# build/ (not committed) and is never bench_caps.json, whose caps are the
# JAX package's, keyed by its raster method.
CAPS_VERSION = 1
CAPS_CACHE_PATH = os.path.join(raster_mod.BUILD_DIR, "bench_caps_torch.json")
_CAPS_FIELDS = (
    "p_cap", "blend_layers", "clip_layers", "particle_layers",
    "shade_px_cap", "shade_px_caps", "opaque_px_cap", "sky_px_cap",
    "matq_classic_cap", "clip_px_caps",
)
_PKG = os.path.dirname(os.path.abspath(__file__))
CAPS_SOURCES = tuple(os.path.join(_PKG, *p) for p in (
    ("scenes.py",), ("render", "caps.py"), ("render", "frame.py")))


def _caps_cache_key(tag, width, height, fixtures=(), scene_kw=None):
    h = hashlib.sha1(json.dumps(scene_kw or {}, sort_keys=True).encode())
    for f in fixtures:
        try:
            with open(f, "rb") as fh:
                h.update(fh.read())
        except OSError:
            h.update(b"missing:" + f.encode())
    clusters = (f"r{raster_mod.RASTER_CLUSTER}k{raster_mod.KBUFFER_CLUSTER}"
                f"d{raster_mod.KBUFFER_DEEP_CLUSTER}")
    return f"{tag}-{width}x{height}-v{CAPS_VERSION}-{clusters}-{h.hexdigest()[:12]}"


def _caps_cache_load(key):
    if os.environ.get("SC_BENCH_REFIT"):
        return None
    try:
        with open(CAPS_CACHE_PATH) as fh:
            entry = json.load(fh).get(key)
    except (OSError, ValueError):
        return None
    if entry is None:
        return None
    for f in ("shade_px_caps", "clip_px_caps"):
        if entry.get(f) is not None:
            entry[f] = tuple(entry[f])
    return entry


def _caps_cache_store(key, config):
    entry = {f: getattr(config, f) for f in _CAPS_FIELDS}
    for f in ("shade_px_caps", "clip_px_caps"):
        if entry.get(f) is not None:
            entry[f] = list(entry[f])
    try:
        data = {}
        if os.path.exists(CAPS_CACHE_PATH):
            with open(CAPS_CACHE_PATH) as fh:
                data = json.load(fh)
        data[key] = entry
        os.makedirs(os.path.dirname(CAPS_CACHE_PATH), exist_ok=True)
        tmp = f"{CAPS_CACHE_PATH}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(data, fh, indent=1, sort_keys=True)
        os.replace(tmp, CAPS_CACHE_PATH)  # readers never see half a file
    except (OSError, ValueError) as e:
        print(f"# caps cache write failed: {e!r}", file=sys.stderr)


def fit_caps_cached(dev, state0, config, env, cache_key, log=None):
    """render/caps.py fit_caps, through the cache: a hit returns the cached
    caps on `config`, a miss fits and stores them."""
    cached = _caps_cache_load(cache_key)
    if cached is not None:
        print(f"# fit_caps: cache hit {cache_key} -> {cached}", file=sys.stderr, flush=True)
        return replace(config, **cached)
    config = fit_caps(dev, state0, config, env, log=log)
    _caps_cache_store(cache_key, config)
    return config


# --- Timing (bench.py :182-458) ---------------------------------------------

class HostClock:
    """The host's clock, and the device's completion barrier.

    On the card, completion is ``torch.cuda.synchronize()``: it returns once
    every launch queued before it has run, so a window that ends with it
    covers the work it enqueued. The JAX bench needed a one-pixel readback
    (``bench.py`` ``_sync``) because ``block_until_ready`` could return early
    on its TPU's network transport; there is no such transport here, and
    the barrier's own cost is what ``rtt_ms`` reports. Tests pass a fake
    with the same two methods."""

    def __init__(self, device):
        self.device = torch.device(device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def now(self) -> float:
        return time.perf_counter()


def _window_ms(clock, fn, n: int) -> float:
    """ms from the start of n back-to-back calls of fn to the barrier after
    them (the device drained before the start)."""
    clock.sync()
    t0 = clock.now()
    for _ in range(n):
        fn()
    clock.sync()
    return (clock.now() - t0) * 1e3


def _probe_rtt(clock, n: int = 5) -> float:
    """Median ms of one synchronise on an idle stream: the floor the barrier
    adds to every timed window (the JAX bench's transport round trip)."""
    ts = sorted(_window_ms(clock, None, 0) for _ in range(n))
    return ts[len(ts) // 2]


def measure_frame_slope(fn, ns=(1, 2, 8), calls=3, repeats=3, clock=None):
    """PRIMARY metric: the dispatch-count slope of one frame function.

    fn is called n times back to back, then one barrier; for each n the
    median of `calls` such windows. t(n) = fixed + n * frame, so the slope
    (t(n_last) - t(n_first)) / (n_last - n_first) cancels the barrier and
    every fixed cost. The whole set runs `repeats` times; the median repeat
    is reported, (max - min) / median of the repeats' slopes is
    frame_spread, and the slopes between neighbouring n are
    frame_check_ms, which should bracket the slope.

    Returns {"frame_ms", "frame_spread", "frame_check_ms", "rtt_ms",
    "compile_s"}. compile_s is fn's first call to the barrier: the kernels'
    build at first use and the warm-up (main fits the caps and checks the
    frame first, so there the kernels are built already)."""
    clock = clock or HostClock("cuda")
    t0 = clock.now()
    fn()
    clock.sync()
    compile_s = clock.now() - t0
    rtt = _probe_rtt(clock)

    def timed_n(n):
        ts = sorted(_window_ms(clock, fn, n) for _ in range(calls))
        return ts[len(ts) // 2]

    reps = [[timed_n(n) for n in ns] for _ in range(repeats)]
    span = ns[-1] - ns[0]
    reps.sort(key=lambda w: w[-1] - w[0])
    mid = reps[len(reps) // 2]
    fm = (mid[-1] - mid[0]) / span
    lo = (reps[0][-1] - reps[0][0]) / span
    hi = (reps[-1][-1] - reps[-1][0]) / span
    return {
        "frame_ms": fm,
        "frame_spread": (hi - lo) / fm if fm > 0 else None,
        "frame_check_ms": [
            (mid[i + 1] - mid[i]) / (ns[i + 1] - ns[i]) for i in range(len(ns) - 1)
        ],
        "rtt_ms": rtt,
        "compile_s": compile_s,
    }


def measure_device_delta(results, calls=3, repeats=3, budget_s=None, t_start=None,
                         ns=(1, 2, 8), clock=None):
    """The frame slope of each result's r["frame_fn"] (measure_frame_slope's
    keys into r), in order. The JAX bench's k-fold unroll slope has no
    counterpart (an eager frame is no program to unroll); what is kept is
    its contract: once the wall clock since `t_start` passes `budget_s`, the
    remaining results get r["delta_error"] = "skipped: bench budget" and
    their frames are never called, and a failure is reported in
    r["delta_error"], not raised."""
    for r in results:
        if "frame_fn" not in r:
            continue
        if (budget_s is not None and t_start is not None
                and time.time() - t_start > budget_s):
            r["delta_error"] = "skipped: bench budget"
            print(f"# delta[{r.get('tag', '?')}]: skipped (budget {budget_s:.0f}s "
                  "exceeded)", file=sys.stderr, flush=True)
            continue
        try:
            r.update(measure_frame_slope(r["frame_fn"], ns=ns, calls=calls,
                                         repeats=repeats, clock=clock))
        except Exception as e:  # noqa: BLE001 - report, don't kill the bench
            r["delta_error"] = f"{type(e).__name__}: {e}"[:200]


def _measure(frame_fn, device_fn=None, n=10, windows=2, device_windows=2, device_n=10,
             warmup=3, clock=None):
    """Returns {"fps", "compile_s", "img", "device_ms", "device_spread"}.

    fps: the median over `windows` windows of n frames of frame_fn(t), each
    building its frame state on the host first (palette FK, draw build,
    upload) as an app loop does, the window ended by the barrier: the rate
    such a loop gets. device_ms: the fastest of `device_windows` windows of
    `device_n` replays of one built frame (device_fn), ms a frame, and
    device_spread the windows' (max - min) / min. On the card the barrier
    waits for the frames (the JAX bench's did not, so there both were
    dispatch rates); the slope (measure_frame_slope) is still the steady
    period, these are windows with their fixed costs in."""
    clock = clock or HostClock("cuda")
    t0 = clock.now()
    img = frame_fn(0.0)
    clock.sync()
    compile_s = clock.now() - t0
    for i in range(warmup):
        frame_fn(0.1 * (i + 1))
    rates = []
    for w in range(windows):
        clock.sync()
        t0 = clock.now()
        for i in range(n):
            img = frame_fn(0.01 * i + w)
        clock.sync()
        rates.append(n / (clock.now() - t0))
    out = {"fps": statistics.median(rates), "compile_s": compile_s, "img": img,
           "device_ms": None, "device_spread": None}
    if device_fn is not None:
        device_fn()
        times = [_window_ms(clock, device_fn, device_n) / device_n
                 for _ in range(device_windows)]
        out["device_ms"] = min(times)
        out["device_spread"] = (max(times) - min(times)) / min(times)
    return out


# --- The correctness check ----------------------------------------------------

# kernel -> (the module whose name the frame calls it by, that name, its
# plain version)
PLAIN_VERSIONS = {
    "raster": (frame_mod, "rasterize_sorted", raster_mod.rasterize_sorted_plain),
    "kbuffer": (frame_mod, "kbuffer_sorted", kbuffer_sorted_plain),
    "classic_sample": (sample_mod, "sample_classic", sample_mod.sample_classic_plain),
    "material_sample": (sample_mod, "sample_material", sample_mod.sample_material_plain),
}


@contextlib.contextmanager
def plain_versions(kernels=tuple(PLAIN_VERSIONS)):
    """Inside the block, the named kernels' wrappers are replaced by their
    plain versions where the frame looks them up (the frame then runs
    eagerly); they are put back after."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in
             (PLAIN_VERSIONS[k] for k in kernels)]
    try:
        for k in kernels:
            mod, name, plain = PLAIN_VERSIONS[k]
            setattr(mod, name, plain)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_kernels_frame(scene_dev, state0, config, env):
    """The frame rendered with every kernel's plain version in place of its
    wrapper (plain_versions: the raster, the k-buffer and the two material
    samplers)."""
    with plain_versions():
        return frame_mod.render_frame(scene_dev, state0, config, env)


# --- main (bench.py :999-1333) ------------------------------------------------

def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_record(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu"}
    name, limit = smi_line().rsplit(", ", 1)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(), "name": name, "power_limit": limit}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: run the code path on the CPU (tests); its times are not "
                         "the card's")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device (torch.cuda.is_available() is False); "
                         "--device cpu runs the code path on the CPU, not the card")
    if device.type == "cuda":
        device = torch.device("cuda", 0)
    runs = CARD_RUNS if device.type == "cuda" else CPU_RUNS
    clock = HostClock(device)
    w, h = args.width, args.height
    record = device_record(device)
    t_bench0 = time.time()
    budget_s = float(os.environ.get("SC_BENCH_BUDGET_S", "1000"))
    deadline_s = float(os.environ.get("SC_BENCH_DEADLINE_S", "900"))
    metric = HEADLINE_METRIC.format(w=w, h=h)

    # Last-resort line: if the primary has not landed by the deadline, print
    # value 0.0 with an error. The real line, if it lands later, prints
    # after it and wins; the lock keeps the two from interleaving.
    landed = threading.Event()
    emit_lock = threading.Lock()

    def watchdog():
        if landed.wait(deadline_s):
            return
        with emit_lock:
            if landed.is_set():
                return
            print(json.dumps({
                "metric": metric, "value": 0.0, "unit": "fps", "vs_baseline": 0.0,
                "error": f"primary metric did not land within {deadline_s:.0f}s -- see stderr",
                "device": record,
            }), flush=True)

    threading.Thread(target=watchdog, daemon=True).start()

    def progress(msg):
        print(f"# [{time.time() - t_bench0:7.1f}s] {msg}", file=sys.stderr, flush=True)

    def over_budget():
        return time.time() - t_bench0 > budget_s

    def fit_log(stats, grow):
        progress(f"fit_caps: {stats} grow={grow or None}")

    out = {"metric": metric, "value": 0.0, "unit": "fps", "vs_baseline": 0.0}

    def emit():
        with emit_lock:
            landed.set()
            print(json.dumps(out), flush=True)

    def add(prefix, r, views=1):
        """The JAX bench's keys for result r under `prefix`: dispatch_ms /
        dispatch_spread (_measure's replays), device_frame_ms, its spread
        and checks, mpix_per_s, rtt_ms, device_delta_error; and the traced
        run's device_busy_ms, idle_share, launches_per_frame."""
        if r.get("device_ms") is not None:
            out[f"{prefix}dispatch_ms"] = round(r["device_ms"], 3)
            out[f"{prefix}dispatch_spread"] = round(r["device_spread"], 3)
        if r.get("frame_ms") is not None:
            out[f"{prefix}device_frame_ms"] = round(r["frame_ms"], 3)
            out[f"{prefix}mpix_per_s"] = round(w * h * views / (r["frame_ms"] * 1e-3) / 1e6, 2)
            if r.get("frame_spread") is not None:
                out[f"{prefix}device_frame_spread"] = round(r["frame_spread"], 3)
            out[f"{prefix}device_frame_check_ms"] = [round(d, 3) for d in r["frame_check_ms"]]
        if r.get("rtt_ms") is not None:
            out[f"{prefix}rtt_ms"] = round(r["rtt_ms"], 3)
        if r.get("delta_error"):
            out[f"{prefix}device_delta_error"] = r["delta_error"]
        for key, digits in (("device_busy_ms", 3), ("idle_share", 3),
                            ("launches_per_frame", 1)):
            if key in r:
                out[prefix + key] = None if r[key] is None else round(r[key], digits)

    def traced(r, frame):
        """The separate traced run (profiler on, after the timed windows)."""
        if not runs.traced or not r.get("frame_ms"):
            r.update(device_busy_ms=None, idle_share=None, launches_per_frame=None)
            return
        _prof, busy_ms, launches = trace_frames(frame, runs.traced)
        r.update(device_busy_ms=busy_ms, idle_share=idle_share(busy_ms, r["frame_ms"]),
                 launches_per_frame=launches)

    def prepare(tag, make, fixtures=()):
        kw = runs.cuts.get(tag, {})
        dev, build, config, env = make(w, h, device, **kw)
        state0 = build(0.0)
        key = _caps_cache_key(tag, w, h, tuple(fixtures) + CAPS_SOURCES, kw)
        config = fit_caps_cached(dev, state0, config, env, key, log=fit_log)
        return dev, build, config, env, state0

    def describe(tag, desc):
        cut = runs.cuts.get(tag)
        return desc.format(w=w, h=h) + (f"; cut for the CPU: {cut}" if cut else "")

    def checked(tag, dev, state0, config, env):
        """The untimed check: the fitted frame against its plain-versions twin,
        byte for byte; a frame that differs marks the line incorrect."""
        img = render_frame(dev, state0, config, env)
        ok = torch.equal(img, plain_kernels_frame(dev, state0, config, env))
        progress(f"{tag}: fitted frame equals its plain-versions twin: {ok}")
        if not ok:
            out["correct"] = False
            out.setdefault("incorrect", []).append(tag)
        return ok, img

    try:
        # --- PRIMARY metric: the headline's frame slope, emitted at once ---
        progress("headline scene (load + fit_caps)...")
        dev, _build, config, env, state0 = prepare("headline", headline_scene, (HERO_GLB,))
        out["correct"] = True
        ok, img = checked("headline", dev, state0, config, env)
        head = {"tag": "headline"}
        if ok:
            progress("headline primary (dispatch-count slope)...")

            def head_frame():
                return render_frame(dev, state0, config, env)

            head.update(measure_frame_slope(head_frame, runs.ns, runs.calls, runs.repeats,
                                            clock))
            fps = 1e3 / head["frame_ms"] if head["frame_ms"] > 0 else 0.0
            out.update(value=round(fps, 2), vs_baseline=round(fps / 60.0, 3))
            add("", head)
        else:
            out["error"] = "the headline frame differs from its plain-versions twin"
        out.update(timing=TIMING, device=record)
        emit()
        if ok:
            progress("headline traced run (device busy time)...")
            traced(head, head_frame)
            add("", head)
            emit()
        if os.environ.get("SC_BENCH_SAVE"):
            write_png(os.environ["SC_BENCH_SAVE"], img[0].cpu().numpy())

        # --- all passes ---
        if not over_budget():
            try:
                progress("all-passes scene (load + fit_caps)...")
                adev, _abuild, acfg, aenv, astate0 = prepare(
                    "all_passes", all_passes_scene, (TERRAIN_GLB,))
                ok, aimg = checked("all_passes", adev, astate0, acfg, aenv)
                out["all_passes_scene"] = describe("all_passes", ALL_PASSES_DESC)
                if ok:
                    progress("all-passes dispatch-count slope...")

                    def all_frame():
                        return render_frame(adev, astate0, acfg, aenv)

                    allp = {"tag": "all_passes"}
                    allp.update(measure_frame_slope(all_frame, runs.ns, runs.calls,
                                                    runs.repeats, clock))
                    out["all_passes_true_fps"] = round(1e3 / allp["frame_ms"], 2)
                    add("all_passes_", allp)
                    emit()
                    progress("all-passes traced run...")
                    traced(allp, all_frame)
                    add("all_passes_", allp)
                if os.environ.get("SC_BENCH_SAVE"):
                    write_png(os.environ["SC_BENCH_SAVE"].replace(".png", "_all.png"),
                              aimg[0].cpu().numpy())
            except Exception as e:  # noqa: BLE001 -- the primary is already out
                print(f"# all-passes bench failed: {e!r}", file=sys.stderr)
                out["all_passes_error"] = f"{type(e).__name__}: {e}"[:200]
            emit()

        # --- stereo + animated ---
        if not over_budget():
            try:
                progress("stereo+animated scene (load + fit_caps)...")
                sdev, sbuild, scfg, senv, sstate0 = prepare("stereo", stereo_animated_scene)
                ok, _simg = checked("stereo_anim", sdev, sstate0, scfg, senv)
                out["stereo_anim_scene"] = describe("stereo", STEREO_DESC)
                if ok:
                    def stereo_frame():
                        return render_frame(sdev, sstate0, scfg, senv)

                    progress("stereo host-build windows...")
                    stereo = _measure(lambda t: render_frame(sdev, sbuild(t), scfg, senv),
                                      stereo_frame, clock=clock, **runs.window)
                    stereo.update(tag="stereo", frame_fn=stereo_frame)
                    progress("stereo dispatch-count slope...")
                    measure_device_delta([stereo], runs.calls, runs.repeats, budget_s,
                                         t_bench0, ns=runs.stereo_ns, clock=clock)
                    out["stereo_anim_dispatch_fps"] = round(stereo["fps"], 2)
                    if stereo.get("frame_ms") and stereo["frame_ms"] > 0:
                        out["stereo_anim_true_fps"] = round(1e3 / stereo["frame_ms"], 2)
                    progress("stereo traced run...")
                    traced(stereo, stereo_frame)
                    add("stereo_anim_", stereo, views=2)
            except Exception as e:  # noqa: BLE001
                print(f"# stereo+animated bench failed: {e!r}", file=sys.stderr)
                out["stereo_anim_error"] = f"{type(e).__name__}: {e}"[:200]
            emit()

        # --- the card's ceilings ---
        if not over_budget():
            try:
                progress("roofline: ceiling probes (matmul/stream/gather)...")
                ceil = probe_ceilings(ns=(1, 2), calls=2, device=device,
                                      sizes=runs.ceiling_sizes)
                # a probe whose slope came out <= 0 has no rate (null)
                for key, digits in (("matmul_tflops", 4), ("stream_gbps", 3),
                                    ("gather_gbps", 3), ("gather_mrows_per_s", 1)):
                    v = ceil[key]
                    out[f"{key}_ceiling"] = None if v is None else round(v, digits)
            except Exception as e:  # noqa: BLE001
                print(f"# roofline block failed: {e!r}", file=sys.stderr)
                out["roofline_error"] = f"{type(e).__name__}: {e}"[:200]
            emit()
    finally:
        landed.set()  # the watchdog prints nothing after main is done

    progress("done")
    emit()
    print(f"# device={record} headline first timed call "
          f"{head.get('compile_s', float('nan')):.3f}s", file=sys.stderr)
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""Where the time of a frame goes on the GPU.

    python3 -m superconductor_tpu_torch.profile_frame
        [--scene headline|clip_blend|all_passes|stereo|lit_passes|app]
        [--frames 5] [--out build/profile] [--sync-sites] [--sites]

Fits the caps of the 1920x1080 frame of `--scene` (the opaque headline;
clip_blend: alpha clip + alpha blend; all_passes: the terrain, the sphere
ring, lines and particles with every pass on; stereo: two eyes of the
skinned tubes and spheres; lit_passes: all_passes with the SH light volume,
a lightmapped wall and the smoke pool; app: the frame server's frames,
python -m superconductor_tpu_torch.serve's app on dense_terrain.glb after
its capacity probe, the camera moving as in its selftest, each frame one
App.update()), warms up, then traces
`--frames` frames with torch.profiler (CPU + CUDA activity). Prints the
wall time per frame (host clock around synchronised frames), the summed
device kernel time and the kernel launches per frame, the device's idle
share, and the top operators by device time; for stereo also the host
time per frame of the palette FK and the frame state's build and upload
(scenes.stereo_animated_scene build(t)); for app also the host ms per
frame of each FrameProfiler scope and the device-synchronising calls per
frame (torch.cuda.set_sync_debug_mode); writes the full table and
a gzipped Chrome trace under `--out` (profile_frame[_<scene>].txt and
.json.gz). With --sync-sites (not for app) it prints instead the lines
of the port at which one eager frame (render_frame_impl) synchronises with
the host, and how often (sync_sites). With --sites (not for app) it prints
instead the device time of one eager traced frame (render_frame_impl) by
call site and kind of operation (call_site_times). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import gzip
import os
import re
import shutil
import sys
import time
import types

import torch

# the warning of a synchronising call under torch.cuda.set_sync_debug_mode
# ("warn"); the mode's own one-time notice that it is a prototype, which
# also names synchronising operations, is not one
SYNC_WARNING = "called a synchronizing CUDA operation"
# call_site_times: a device operation's site is the innermost of these
# functions of the port that it ran under (site_ranges); its kind is
# "gather" when the benchmark's GATHERS pattern (benchmark/measure.py)
# matches the kernel's name, "hand" for a hand-written kernel, else the
# host op's name
SITE_FUNCTIONS = (
    "_material_rows", "_material_rows_mq", "classic_sample", "sample_classic",
    "sample_material_interleaved", "sample_material", "_partition_material_sample", "take",
    "compose", "_compact_worklist", "interpolate_gbuffer", "sample_skybox",
    "sample_skybox_at", "albedo_alpha", "shade", "shade_particles", "render_view",
)
SITE_PREFIX = "site:"
GATHER_KERNEL = re.compile(r"gather|index", re.IGNORECASE)
HAND_KERNEL = re.compile(r"\b(raster_sorted|kbuffer_sorted|kbuffer_deep|kbuffer_global|"
                         r"classic_sample|material_sample)_kernel\b")


def _app_frames(args):
    """-> (frame(), config, world): one App.update() of the frame server's app
    (serve.prepare with its capacity probe) per call, after the model has
    loaded, the camera stepping as in serve's selftest; config is the
    served RenderConfig once the first frames have run."""
    from .ecs.resources import CameraResource, FrameOutput, RenderSettings
    from .serve import parse_args, prepare, wait_for_models

    server = prepare(parse_args(["--size", f"{args.width}x{args.height}"]))
    if server.probe_failed:
        raise SystemExit(f"profile_frame: the capacity probe failed: {server.probe_failed}")
    app, rig = server.app, server.rig
    cam = app.world.resource(CameraResource).camera
    out = app.world.resource(FrameOutput)
    cam.position, cam.rotation = rig.update(1 / 60.0)
    wait_for_models(app)
    n = [0]

    def frame():
        keys = frozenset(("w", "w+d", "w+a", "s")[(n[0] // 30) % 4].split("+"))
        rig.apply_keys(keys, dt=1 / 60.0, mouse=(0.5, 0.0))
        cam.position, cam.rotation = rig.update(1 / 60.0)
        app.update()
        n[0] += 1
        return out.image

    frame()
    return frame, app.world.resource(RenderSettings).config, app.world


def _app_host_report(frame, world, frames: int) -> None:
    """Print the host ms per frame of each FrameProfiler scope of the
    render system, and the calls per frame that wait on the device (each
    a warning under torch.cuda.set_sync_debug_mode("warn"))."""
    import collections
    import warnings

    from .utils.profiler import FrameProfiler

    prof = FrameProfiler()
    world.insert_resource(prof)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(frames):
                frame()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    world.resources.pop(FrameProfiler)
    syncs = [str(w.message) for w in caught if SYNC_WARNING in str(w.message)]
    print("host ms/frame by scope: " + ", ".join(
        f"{k} {prof.totals[k] * 1e3 / frames:.3f}" for k in sorted(prof.totals)))
    print(f"device-synchronising calls: {len(syncs) / frames:.1f}/frame")
    for msg, count in collections.Counter(m.splitlines()[0][:120] for m in syncs).most_common(5):
        print(f"  {count / frames:.1f}/frame: {msg}")


def sync_sites(fn) -> collections.Counter:
    """Run fn() under torch.cuda.set_sync_debug_mode("warn") -> how many
    device-synchronising calls each line of the port made ("path:line" of
    the innermost frame of the port's package, this file left out, in the
    stack of each warning; the warning's own line where the stack holds
    none)."""
    import traceback
    import warnings

    pkg = os.path.dirname(os.path.abspath(__file__))
    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            return
        port = [f for f in traceback.extract_stack()
                if f.filename.startswith(pkg) and f.filename != __file__]
        if port:
            filename, lineno = os.path.relpath(port[-1].filename, os.path.dirname(pkg)), \
                port[-1].lineno
        sites[f"{filename}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


@contextlib.contextmanager
def site_ranges():
    """Inside the block, each function of the port named in SITE_FUNCTIONS
    (every module's binding of it, and a class's method of that name) runs
    inside a torch.profiler.record_function range "site:file:function"."""
    from torch.profiler import record_function

    def ranged(fn):
        label = f"{SITE_PREFIX}{os.path.basename(fn.__code__.co_filename)}:{fn.__name__}"

        @functools.wraps(fn)
        def run(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return run

    package = __package__ or "superconductor_tpu_torch"
    owners = [m for n, m in list(sys.modules.items())
              if m is not None and n.startswith(package + ".")]
    owners += [c for m in owners for c in list(vars(m).values())
               if isinstance(c, type) and c.__module__ == m.__name__]
    saved, wrappers = [], {}
    for owner in owners:
        for name, obj in list(vars(owner).items()):
            if (isinstance(obj, types.FunctionType) and obj.__name__ in SITE_FUNCTIONS
                    and obj.__module__.startswith(package)):
                saved.append((owner, name, obj))
                setattr(owner, name, wrappers.setdefault(obj, ranged(obj)))
    try:
        yield
    finally:
        for owner, name, obj in saved:
            setattr(owner, name, obj)


def call_site_times(fn) -> dict:
    """Run fn() once under torch.profiler (CPU and CUDA activity, input
    shapes) and site_ranges -> {(site, kind, rows): [device ms, device
    operations]}: each device operation under the host op that launched
    it, at the innermost site range around that op ("file:function";
    "(frame)" outside them all), of kind "gather" (the kernel's name
    matches GATHER_KERNEL; rows: the gathered tensor's row width), "hand"
    (a hand-written kernel; rows: its name) or the host op's name."""
    from torch.profiler import ProfilerActivity, profile

    with site_ranges(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    # a device event shares its id with the runtime call that launched it,
    # whose parent is the host op
    runtime = {e.id: e for e in events if e.device_type != cuda and e.name.startswith("cuda")}
    out = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        # device operations only: not the ranges' device-side annotations
        if e.device_type != cuda or getattr(e, "is_user_annotation", False) \
                or e.name.startswith(SITE_PREFIX):
            continue
        r = runtime.get(e.id)
        op = r.cpu_parent if r is not None else None
        site, p = "(frame)", op
        while p is not None:
            if p.name.startswith(SITE_PREFIX):
                site = p.name[len(SITE_PREFIX):]
                break
            p = p.cpu_parent
        rows = ""
        hand = HAND_KERNEL.search(e.name)
        if hand:
            kind, rows = "hand", hand.group(0)
        elif GATHER_KERNEL.search(e.name):
            kind = "gather"
            shapes = getattr(op, "input_shapes", None) or []
            if shapes and isinstance(shapes[0], (list, tuple)) and shapes[0]:
                rows = f"{shapes[0][-1] if len(shapes[0]) > 1 else 1} wide"
        else:
            kind = (op.name if op is not None else e.name).replace("aten::", "")
        cell = out[(site, kind, rows)]
        cell[0] += e.time_range.elapsed_us() / 1e3
        cell[1] += 1
    return dict(out)


def print_site_times(times: dict, top: int = 60) -> None:
    """call_site_times' sites by device ms (all kinds), each kind's total,
    then the `top` (site, kind, rows) cells."""
    total = sum(ms for ms, _ in times.values())

    def sums(key):
        out = collections.defaultdict(lambda: [0.0, 0])
        for k, (ms, n) in times.items():
            out[key(k)][0] += ms
            out[key(k)][1] += n
        return sorted(out.items(), key=lambda kv: -kv[1][0])

    print(f"by site (of {total:.3f} ms device time): " + ", ".join(
        f"{site} {ms:.3f} ms in {n}" for site, (ms, n) in sums(lambda k: k[0])))
    print("by kind: " + ", ".join(
        f"{kind} {ms:.3f} ms in {n}" for kind, (ms, n) in sums(lambda k: k[1])))
    print(f"{'ms':>9} {'ops':>6}  site / kind / rows")
    for (site, kind, rows), (ms, n) in sorted(times.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"{ms:9.3f} {n:6d}  {site} / {kind}" + (f" / {rows}" if rows else ""))


def trace_frames(frame, frames: int):
    """`frames` calls of frame() traced with torch.profiler (CPU and CUDA
    activity), ending in a synchronise -> (the profile, the summed device
    time of a frame in ms, the device events a frame: kernel launches and
    copies)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            frame()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / frames
    return prof, device_ms, len(kernels) / frames


def idle_share(device_ms: float, wall_ms: float) -> float:
    """The share of a frame's wall time in which the device runs no kernel."""
    return max(0.0, 1.0 - device_ms / wall_ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="headline",
                    choices=("headline", "clip_blend", "all_passes", "stereo", "lit_passes",
                             "app"))
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    ap.add_argument("--sync-sites", action="store_true",
                    help="print where an eager frame synchronises with the host, and stop")
    ap.add_argument("--sites", action="store_true",
                    help="print an eager frame's device time by call site, and stop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: no CUDA device")
    if (args.sync_sites or args.sites) and args.scene == "app":
        raise SystemExit("profile_frame: --sync-sites and --sites take a scene, not the app")

    from .render.caps import fit_caps
    from .render.frame import render_frame
    from .scenes import (
        all_passes_scene,
        clip_blend_scene,
        headline_scene,
        lit_passes_scene,
        stereo_animated_scene,
    )

    if args.scene == "app":
        frame, config, world = _app_frames(args)
    else:
        make = {"headline": headline_scene, "clip_blend": clip_blend_scene,
                "all_passes": all_passes_scene, "stereo": stereo_animated_scene,
                "lit_passes": lit_passes_scene}[args.scene]
        dev, build, config, env = make(args.width, args.height, "cuda")
        state = build(0.0)
        config = fit_caps(dev, state, config, env)
        if args.sync_sites:
            from .render.frame import render_frame_impl

            render_frame_impl(dev, state, config, env, with_stats=True)
            torch.cuda.synchronize()
            sites = sync_sites(lambda: render_frame_impl(dev, state, config, env,
                                                         with_stats=True))
            print(f"{torch.cuda.get_device_name(0)}; {args.scene}: {sum(sites.values())} "
                  "synchronising calls in an eager frame")
            for site, n in sites.most_common():
                print(f"  {n:5d}  {site}")
            return 0
        if args.sites:
            from .render.frame import render_frame_impl

            for _ in range(2):
                render_frame_impl(dev, state, config, env)
            torch.cuda.synchronize()
            print(f"{torch.cuda.get_device_name(0)}; {args.scene}: one eager frame's device "
                  "time by call site")
            print_site_times(call_site_times(lambda: render_frame_impl(dev, state, config, env)))
            return 0

        def frame():
            return render_frame(dev, state, config, env)

    for _ in range(3):
        frame()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(args.frames):
        frame()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.frames
    if args.scene == "app":
        _app_host_report(frame, world, args.frames)
    if args.scene == "stereo":
        t0 = time.perf_counter()
        for i in range(args.frames):
            build(0.1 * (i + 1))
        torch.cuda.synchronize()
        print(f"host: palette FK + frame state build and upload "
              f"{(time.perf_counter() - t0) * 1e3 / args.frames:.3f} ms/frame")

    prof, device_ms, launches = trace_frames(frame, args.frames)
    events = prof.key_averages()
    print(f"device: {torch.cuda.get_device_name(0)}; scene: {args.scene}")
    print(f"caps: p_cap={config.p_cap} opaque_px_cap={config.opaque_px_cap} "
          f"clip_layers={config.clip_layers} blend_layers={config.blend_layers} "
          f"particle_layers={config.particle_layers} shade_px_caps={config.shade_px_caps} "
          f"sky_px_cap={config.sky_px_cap} matq_classic_cap={config.matq_classic_cap}")
    print(f"wall {wall_ms:.3f} ms/frame (host clock, synchronised, profiler off); "
          f"device kernels {device_ms:.3f} ms/frame, {launches:.0f} "
          f"kernel launches/frame; idle share {idle_share(device_ms, wall_ms):.3f}")
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    print(table)
    os.makedirs(args.out, exist_ok=True)
    stem = "profile_frame" + ("" if args.scene == "headline" else f"_{args.scene}")
    with open(os.path.join(args.out, stem + ".txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=200))
    # the trace of a frame with thousands of launches runs to tens of MB;
    # gzip takes it to a tenth
    trace = os.path.join(args.out, stem + ".json")
    prof.export_chrome_trace(trace)
    with open(trace, "rb") as src, gzip.open(trace + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.unlink(trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the time of a frame goes on the GPU.

    python3 -m superconductor_tpu_torch.profile_frame
        [--scene headline|clip_blend|all_passes|stereo|lit_passes|app]
        [--frames 5] [--out build/profile]

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
.json.gz). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gzip
import os
import shutil
import sys
import time

import torch


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
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    print("host ms/frame by scope: " + ", ".join(
        f"{k} {prof.totals[k] * 1e3 / frames:.3f}" for k in sorted(prof.totals)))
    print(f"device-synchronising calls: {len(syncs) / frames:.1f}/frame")
    for msg, count in collections.Counter(m.splitlines()[0][:120] for m in syncs).most_common(5):
        print(f"  {count / frames:.1f}/frame: {msg}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="headline",
                    choices=("headline", "clip_blend", "all_passes", "stereo", "lit_passes",
                             "app"))
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: no CUDA device")

    from torch.profiler import ProfilerActivity, profile

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

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.frames):
            frame()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / args.frames
    print(f"device: {torch.cuda.get_device_name(0)}; scene: {args.scene}")
    print(f"caps: p_cap={config.p_cap} opaque_px_cap={config.opaque_px_cap} "
          f"clip_layers={config.clip_layers} blend_layers={config.blend_layers} "
          f"particle_layers={config.particle_layers} shade_px_caps={config.shade_px_caps} "
          f"sky_px_cap={config.sky_px_cap} matq_classic_cap={config.matq_classic_cap}")
    print(f"wall {wall_ms:.3f} ms/frame (host clock, synchronised, profiler off); "
          f"device kernels {device_ms:.3f} ms/frame, {len(kernels) / args.frames:.0f} "
          f"kernel launches/frame; idle share {max(0.0, 1.0 - device_ms / wall_ms):.3f}")
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

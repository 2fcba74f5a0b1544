"""Where the time of a frame goes on the GPU.

    python3 -m superconductor_tpu_torch.profile_frame
        [--scene headline|clip_blend|all_passes|stereo|lit_passes] [--frames 5]
        [--out build/profile]

Fits the caps of the 1920x1080 frame of `--scene` (the opaque headline;
clip_blend: alpha clip + alpha blend; all_passes: the terrain, the sphere
ring, lines and particles with every pass on; stereo: two eyes of the
skinned tubes and spheres; lit_passes: all_passes with the SH light volume,
a lightmapped wall and the smoke pool), warms up, then traces
`--frames` frames with torch.profiler (CPU + CUDA activity). Prints the
wall time per frame (host clock around synchronised frames), the summed
device kernel time and the kernel launches per frame, the device's idle
share, and the top operators by device time; for stereo also the host
time per frame of the palette FK and the frame state's build and upload
(scenes.stereo_animated_scene build(t)); writes the full table and
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="headline",
                    choices=("headline", "clip_blend", "all_passes", "stereo", "lit_passes"))
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

    make = {"headline": headline_scene, "clip_blend": clip_blend_scene,
            "all_passes": all_passes_scene, "stereo": stereo_animated_scene,
            "lit_passes": lit_passes_scene}[args.scene]
    dev, build, config, env = make(args.width, args.height, "cuda")
    state = build(0.0)
    config = fit_caps(dev, state, config, env)
    for _ in range(3):
        render_frame(dev, state, config, env)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(args.frames):
        render_frame(dev, state, config, env)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.frames
    if args.scene == "stereo":
        t0 = time.perf_counter()
        for i in range(args.frames):
            build(0.1 * (i + 1))
        torch.cuda.synchronize()
        print(f"host: palette FK + frame state build and upload "
              f"{(time.perf_counter() - t0) * 1e3 / args.frames:.3f} ms/frame")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.frames):
            render_frame(dev, state, config, env)
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

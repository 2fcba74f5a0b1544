"""Interactive frame server: the continuous present loop of the reference's
run_rendering_loop (src/lib.rs:420-564) on a CUDA device (the port of
``demo/serve.py``).

    python -m superconductor_tpu_torch.serve --selftest 10 [--size 1920x1080]
        [--model PATH] [--frames-in-flight 2] [--device cuda]
    python -m superconductor_tpu_torch.serve --stdin [--size 640x360]

The loop: poll input -> update the camera rig -> run the ECS schedule ->
submit the frame, every frame. "Present" is the frame's tensor being
rendered (its CUDA event reached); --stdin can save the newest frame as a
PNG.

--frames-in-flight N is the swapchain's frame queue (wgpu's
desired_maximum_frame_latency defaults to 2): up to N frames are submitted
before waiting on the oldest, so host draw-build of frame n+1 overlaps the
device's render of frame n where nothing in between waits on the device.
Latency is measured submit->ready per frame, so queue wait is reported,
not hidden.

Two modes:

  --selftest N   drive the loop with synthetic WASD+mouse input at 60 Hz
                 for N seconds and print one JSON report: p50/p90/p99
                 frame latency, throughput, the host ms per frame of each
                 FrameProfiler scope, and the raster and k-buffer kernel
                 launches over the timed frames.

  --stdin        newline-delimited JSON commands on stdin:
                     {"keys": "w+d", "mouse": [dx, dy]}   input delta
                     {"save": "frame.png"}                readback + save
                     {"quit": true}
                 each frame answers with one JSON status line on stdout:
                     {"frame": n, "latency_ms": ..., "p50_ms": ..., "p99_ms": ...}

Zero-read serving and the capacity probe: the frame loop defaults to
stats_interval=0 (no stats read back on the frame loop), which turns off
in-loop bin-pair / k-layer overflow detection. To keep never-drop sizing
anyway, startup runs a CAPACITY PROBE subprocess (``--probe-only``, its own
process and device context): the same scene with stats on over a
deterministic camera sweep; the capacities its growth loop settles on are
what this process serves with. --probe off skips it; a probe that fails
prints ``{"probe_failed": ...}`` on stderr and the server falls back to
p_cap = 2^19, as the reference does.

What differs from the reference: --device (default cuda) where it had
--platform, no compile cache, no --sync (the frame's CUDA event is an
exact barrier on a card attached to its host, so there is no readback
barrier to choose), the model defaults to tests/fixtures/dense_terrain.glb, and where the IBL
cubemap file is absent the procedural gradient cubemap with constant
ambient SH lights the scene (the port's scenes.py sky).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

from .assets import ASSETS_DIR
from .scenes import TERRAIN_GLB

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_IBL = os.path.join(ASSETS_DIR, "cubemaps", "noon.ktx2")
FALLBACK_P_CAP = 1 << 19
# the config fields the capacity probe hands over (the reference's set)
PROBED = ("p_cap", "blend_layers", "shade_px_cap", "opaque_px_cap", "shade_px_caps",
          "clip_layers", "particle_layers")


def add_environment(world, ibl_path) -> None:
    """Queue the IBL cubemap at ibl_path for loading (NewIblCubemap), or,
    where the file is absent, give the scene the procedural gradient
    cubemap and constant ambient SH of the port's scenes."""
    from .ecs.resources import NewIblCubemap, RenderSettings, SceneResource
    from .render.env import EnvBindings
    from .utils.procgen import default_ambient_sh, gradient_cubemap

    if ibl_path and os.path.exists(ibl_path):
        world.insert_resource(NewIblCubemap(ibl_path))
        return
    scene = world.resource(SceneResource).scene
    gradient_cubemap(scene)
    world.resource(RenderSettings).env = EnvBindings.from_scene(
        scene, ambient_sh=default_ambient_sh())


def build_app(width, height, raster, model_path, ibl_path, stats_interval=0,
              p_cap=FALLBACK_P_CAP, blend_layers=None, shade_px_cap=None,
              opaque_px_cap=None, shade_px_caps=None, clip_layers=None,
              particle_layers=None, device="cuda"):
    """The served app: the model at the origin, the environment, and the
    RenderConfig of the reference's server (t_cap 2^18, t_cap_anim 2^8)
    with the given capacities."""
    from .assets.fetch import FileClient
    from .ecs.app import App
    from .ecs.components import Instance, InstanceOf, ModelUrl
    from .ecs.resources import RenderSettings
    from .ecs.systems import CorePlugin
    from .math3d import Similarity
    from .render.frame import RenderConfig

    cfg_kw = {}
    for name, value in (("blend_layers", blend_layers), ("shade_px_cap", shade_px_cap),
                        ("opaque_px_cap", opaque_px_cap), ("clip_layers", clip_layers),
                        ("particle_layers", particle_layers)):
        if value is not None:
            cfg_kw[name] = value
    if shade_px_caps is not None:
        cfg_kw["shade_px_caps"] = tuple(shade_px_caps)
    app = App()
    app.add_plugin(CorePlugin(
        config=RenderConfig(width=width, height=height, t_cap=1 << 18, t_cap_anim=1 << 8,
                            p_cap=p_cap, raster=raster, **cfg_kw),
        client=FileClient(), device=device,
    ))
    w = app.world
    w.resource(RenderSettings).stats_interval = stats_interval
    add_environment(w, ibl_path)
    model_e = w.spawn(ModelUrl(model_path))
    w.spawn(Instance(Similarity()), InstanceOf(model_e))
    return app


def start_rig():
    from .render.rig import FlyCameraRig

    rig = FlyCameraRig(position=(6.0, 3.0, 6.0), speed=6.0)
    rig.look_at((6.0, 3.0, 6.0), (0, 0.5, 0))
    rig.pos = rig.target_pos.copy()
    rig.yaw, rig.pitch = rig.target_yaw, rig.target_pitch
    return rig


def wait_for_models(app, max_updates: int = 100, poll_s: float = 0.05) -> None:
    """Run the schedule until every model entity has loaded (or failed):
    the async decode runs on the fetch client's executor meanwhile."""
    from .ecs.components import AnimatedModelUrl, ModelComponent, ModelUrl, PendingModel

    w = app.world
    for _ in range(max_updates):
        app.update()
        urls = set(w.components.get(ModelUrl, {})) | set(w.components.get(AnimatedModelUrl, {}))
        if all(w.get(e, ModelComponent) is not None for e in urls):
            return
        if not w.components.get(PendingModel):
            return  # the rest failed to load
        time.sleep(poll_s)


def _probe_cmd(args, width, height, model_path, ibl):
    return [sys.executable, "-m", "superconductor_tpu_torch.serve", "--probe-only",
            "--size", f"{width}x{height}", "--raster", args.raster, "--model", model_path,
            "--ibl", ibl, "--device", args.device]


def capacity_probe(args, width, height, model_path, ibl):
    """-> (capacities for build_app, the failure message or None).

    Runs a SUBPROCESS that renders the same scene with stats on
    (stats_interval=1) over a deterministic camera sweep and reports the
    capacities the never-drop growth loop settled on; this process serves
    with them and reads no stats. Steady-state churn beyond what the sweep
    saw can still exceed them (use --stats-interval 1 for full never-drop
    semantics). A failed probe falls back to p_cap = 2^19 with a line on
    stderr."""
    try:
        res = subprocess.run(_probe_cmd(args, width, height, model_path, ibl), cwd=_REPO,
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"probe exited {res.returncode}: {res.stderr[-400:]}")
        caps = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"probe": caps}), file=sys.stderr)
        return {
            "p_cap": int(caps["p_cap"]),
            "blend_layers": int(caps["blend_layers"]),
            "shade_px_cap": int(caps.get("shade_px_cap", 0)) or None,
            "opaque_px_cap": int(caps.get("opaque_px_cap") or 0) or None,
            "shade_px_caps": tuple(caps["shade_px_caps"]) if caps.get("shade_px_caps") else None,
            "clip_layers": caps.get("clip_layers"),
            "particle_layers": caps.get("particle_layers"),
        }, None
    except Exception as e:  # noqa: BLE001 - the probe is best-effort sizing
        msg = str(e)[:200]
        print(json.dumps({"probe_failed": msg}), file=sys.stderr)
        return {"p_cap": FALLBACK_P_CAP}, msg


def probe_only(args, width, height, model_path, ibl) -> int:
    """Subprocess body of capacity_probe: a stats-on sweep; prints the caps
    as the last line of stdout."""
    from .ecs.resources import CameraResource, RenderSettings

    app = build_app(width, height, args.raster, model_path, ibl, stats_interval=1,
                    device=args.device)
    w = app.world
    cam_res = w.resource(CameraResource)
    rig = start_rig()
    cam_res.camera.position, cam_res.camera.rotation = rig.update(1 / 60.0)
    wait_for_models(app)
    keyset = ["w", "w+d", "w+a", "s", "w+e", "w+q", "d", "a"]
    for n in range(24):
        keys = frozenset(keyset[(n // 3) % len(keyset)].split("+"))
        rig.apply_keys(keys, dt=1 / 60.0, mouse=(15.0 * np.sin(0.3 * n), 0.0))
        cam_res.camera.position, cam_res.camera.rotation = rig.update(1 / 60.0)
        app.update()
    cfg = w.resource(RenderSettings).config
    caps = {k: getattr(cfg, k) for k in PROBED}
    caps["shade_px_caps"] = list(cfg.shade_px_caps) if cfg.shade_px_caps else None
    print(json.dumps(caps))
    return 0


def prepare(args):
    """The served app and its input rig, after the capacity probe ->
    namespace(app, rig, width, height, model, ibl, probe, probe_failed)."""
    width, height = map(int, args.size.split("x"))
    model_path = args.model or TERRAIN_GLB
    ibl = args.ibl or DEFAULT_IBL
    probed, failed = {"p_cap": FALLBACK_P_CAP}, None
    if args.stats_interval == 0 and args.probe == "auto":
        probed, failed = capacity_probe(args, width, height, model_path, ibl)
    app = build_app(width, height, args.raster, model_path, ibl,
                    stats_interval=args.stats_interval, device=args.device, **probed)
    return SimpleNamespace(app=app, rig=start_rig(), width=width, height=height,
                           model=model_path, ibl=ibl, probe=probed, probe_failed=failed)


def selftest(server, seconds: float, frames_in_flight: int = 1, warmup: int = 5) -> dict:
    """--selftest: synthetic 60 Hz input for `seconds` after the model load
    and `warmup` frames -> the report dict (latency percentiles, fps, host
    ms per frame by FrameProfiler scope, kernel launches over the timed
    frames)."""
    from .ecs.resources import CameraResource, FrameOutput
    from .ops import raster as raster_mod
    from .render.present import PresentQueue
    from .utils.profiler import FrameProfiler

    app, rig = server.app, server.rig
    w = app.world
    cam_res = w.resource(CameraResource)
    out = w.resource(FrameOutput)
    prof = FrameProfiler()
    w.insert_resource(prof)
    dt = 1.0 / 60.0
    depth = max(1, frames_in_flight)
    queue = PresentQueue(depth)

    def present(keys=frozenset(), mouse=(0.0, 0.0)):
        t0 = time.time()
        with prof.scope("input"):
            rig.apply_keys(keys, dt=dt, mouse=mouse)
            cam_res.camera.position, cam_res.camera.rotation = rig.update(dt)
        with prof.scope("app.update"):
            app.update()
        return queue.submit(out.image, t_start=t0)

    cam_res.camera.position, cam_res.camera.rotation = rig.update(dt)
    wait_for_models(app)
    for _ in range(warmup):
        present()
    list(queue.drain())  # enter the measured loop with an empty queue
    prof.reset()

    keyset = ["w", "w", "w+d", "w+d", "w+a", "s", "w+e", "w+q"]
    lat = []
    launches0 = (raster_mod.rasterize_sorted.LAUNCHES, raster_mod.kbuffer_sorted.LAUNCHES)
    t_start = time.time()
    n = 0
    while time.time() - t_start < seconds:
        keys = frozenset(keyset[(n // 30) % len(keyset)].split("+"))
        mouse = (1.1 * np.sin(0.02 * n), 0.35 * np.cos(0.013 * n))
        s = present(keys, mouse)
        if s is not None:
            lat.append(s)
        n += 1
    lat.extend(queue.drain())
    total = time.time() - t_start
    lat_ms = np.array(lat) * 1e3
    cfg = out.last_config
    return {
        "mode": "selftest",
        "frames": n,
        "frames_in_flight": depth,
        "seconds": total,
        "fps": n / total,
        "latency_p50_ms": float(np.percentile(lat_ms, 50)),
        "latency_p90_ms": float(np.percentile(lat_ms, 90)),
        "latency_p99_ms": float(np.percentile(lat_ms, 99)),
        "latency_max_ms": float(lat_ms.max()),
        "size": f"{server.width}x{server.height}",
        "sustained_60fps": bool(n / total >= 60.0),
        "host_ms_per_frame": {k: prof.totals[k] * 1e3 / n for k in sorted(prof.totals)},
        "raster_launches": raster_mod.rasterize_sorted.LAUNCHES - launches0[0],
        "kbuffer_launches": raster_mod.kbuffer_sorted.LAUNCHES - launches0[1],
        "views_x_bands": cfg.num_views * max(cfg.row_chunks, 1),
        "probe": server.probe,
        "probe_failed": server.probe_failed,
    }


def serve_stdin(server, frames_in_flight: int = 1) -> int:
    """--stdin: one frame per input line, a JSON status line per frame."""
    from .ecs.resources import CameraResource, FrameOutput
    from .render.present import PresentQueue
    from .utils.image import write_png

    app, rig = server.app, server.rig
    w = app.world
    cam_res = w.resource(CameraResource)
    out = w.resource(FrameOutput)
    dt = 1.0 / 60.0
    queue = PresentQueue(max(1, frames_in_flight))
    cam_res.camera.position, cam_res.camera.rotation = rig.update(dt)
    wait_for_models(app)
    lat_hist = []
    n = 0
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            cmd = json.loads(line)
        except json.JSONDecodeError:
            print(json.dumps({"error": "bad json"}), flush=True)
            continue
        if cmd.get("quit"):
            break
        if "save" in cmd:
            lat_hist.extend(s * 1e3 for s in queue.drain())  # newest frame
            write_png(cmd["save"], out.image[0].cpu().numpy())
            print(json.dumps({"saved": cmd["save"]}), flush=True)
            continue
        keys = frozenset(k for k in str(cmd.get("keys", "")).split("+") if k)
        t0 = time.time()
        rig.apply_keys(keys, dt=dt, mouse=tuple(cmd.get("mouse", (0.0, 0.0))))
        cam_res.camera.position, cam_res.camera.rotation = rig.update(dt)
        app.update()
        s = queue.submit(out.image, t_start=t0)
        n += 1
        if s is None:  # pipeline still filling
            print(json.dumps({"frame": n, "queued": True}), flush=True)
            continue
        lat_hist.append(s * 1e3)
        hist = np.array(lat_hist[-600:])
        print(json.dumps({"frame": n, "latency_ms": round(s * 1e3, 2),
                          "p50_ms": round(float(np.percentile(hist, 50)), 2),
                          "p99_ms": round(float(np.percentile(hist, 99)), 2)}), flush=True)
    return 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="1920x1080")
    ap.add_argument("--raster", default="auto")
    ap.add_argument("--model", default=None)
    ap.add_argument("--ibl", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--selftest", type=float, default=0.0,
                    help="run N seconds of synthetic 60 Hz input and report")
    ap.add_argument("--stdin", action="store_true", help="read JSON input deltas from stdin")
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--frames-in-flight", type=int, default=1,
                    help="present-queue depth: submit up to N frames before waiting on the "
                    "oldest (wgpu's default desired_maximum_frame_latency is 2); 1 = fully "
                    "synchronous; latency is still measured submit->ready per frame")
    ap.add_argument("--stats-interval", type=int, default=0,
                    help="device-stats read period for overflow detection (0 = never read "
                    "on the frame loop; the capacity probe sizes the caps instead)")
    ap.add_argument("--probe", choices=("auto", "off"), default="auto",
                    help="capacity probe before zero-read serving (auto = when "
                    "--stats-interval 0)")
    ap.add_argument("--probe-only", action="store_true", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.probe_only:
        width, height = map(int, args.size.split("x"))
        return probe_only(args, width, height, args.model or TERRAIN_GLB,
                          args.ibl or DEFAULT_IBL)
    if not (args.selftest > 0 or args.stdin):
        print("pass --selftest N or --stdin", file=sys.stderr)
        return 1
    server = prepare(args)
    if args.selftest > 0:
        print(json.dumps(selftest(server, args.selftest, args.frames_in_flight, args.warmup)))
        return 0
    return serve_stdin(server, args.frames_in_flight)


if __name__ == "__main__":
    sys.exit(main())

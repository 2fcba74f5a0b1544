"""Demo app: the analog of the reference's demo crate (demo/src/lib.rs) on a
CUDA device (the port of ``demo/demo.py``).

Loads a glTF scene through the ECS, the light volume and IBL cubemap where
their files are present, sets up a smoothed camera path, and renders N
frames to PNG files.

    python -m superconductor_tpu_torch.demo [--model PATH] [--frames N]
        [--size WxH] [--out DIR] [--raster auto|ref|pallas] [--device cuda]
        [--particles] [--debug-lines] [--debug-overlays]
        [--animated-model PATH] [--path orbit|fly] [--script FILE]

What differs from the reference: --device (default cuda), no compile
cache, the content comes from ``assets.ASSETS_DIR`` (the reference's asset
layout) and falls back to tests/fixtures/hero_helmet.glb for the model and
to the procedural gradient cubemap with constant ambient SH for the sky
where those files are absent, the frame loop starts once every model has
loaded (so the N frames show the scene), the PNGs are written without an
imaging library (utils/image.py), --out defaults to sc_demo in the
temporary directory, and there is no --head-turn (the reference's VRM
head-turn analog: the repository holds no VRM content for it to turn).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from .assets import ASSETS_DIR
from .scenes import HERO_GLB


def default_model() -> str:
    """Sponza (when its .bin is there too), sponza_cubes.glb, or the
    repository's hero helmet."""
    sponza = os.path.join(ASSETS_DIR, "models", "Sponza", "glTF", "Sponza.gltf")
    if os.path.exists(sponza) and os.path.exists(os.path.join(os.path.dirname(sponza),
                                                              "Sponza.bin")):
        return sponza
    cubes = os.path.join(ASSETS_DIR, "models", "sponza_cubes.glb")
    return cubes if os.path.exists(cubes) else HERO_GLB


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default=None, help="glTF/GLB path (default: see default_model)")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", default="640x360")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "sc_demo"))
    ap.add_argument("--raster", default="auto")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--particles", action="store_true", help="spawn test particles")
    ap.add_argument("--debug-lines", action="store_true", help="ground grid lines")
    ap.add_argument("--debug-overlays", action="store_true",
                    help="skeleton + bounding-box line overlays (src/systems/debugging.rs)")
    ap.add_argument("--path", default="orbit", choices=["orbit", "fly"],
                    help="camera path: smoothed orbit, or a scripted fly-through")
    ap.add_argument("--script", default=None,
                    help="camera script file for --path fly (see render/rig.py syntax)")
    ap.add_argument("--animated-model", default=None,
                    help="additionally spawn an animated glTF/GLB at the origin")
    ap.add_argument("--ibl", default=None,
                    help="IBL cubemap ktx2 (default: cubemaps/noon.ktx2 under ASSETS_DIR)")
    return ap.parse_args(argv)


def build_app(args):
    """The demo's app: the model (and the animated model) at the origin,
    the environment, the debug content systems."""
    from .assets.fetch import FileClient
    from .ecs.app import App, Stage
    from .ecs.components import AnimatedModelUrl, Instance, InstanceOf, ModelUrl
    from .ecs.resources import LineBuffer, NewLightvolTextures, ParticleBuffer
    from .ecs.systems import CorePlugin
    from .math3d import Similarity
    from .render.frame import RenderConfig
    from .serve import add_environment

    width, height = map(int, args.size.split("x"))
    app = App()
    app.add_plugin(CorePlugin(
        config=RenderConfig(
            width=width, height=height, t_cap=1 << 18, t_cap_anim=1 << 8, p_cap=1 << 19,
            raster=args.raster, enable_clip=True, enable_blend=True,
            enable_lines=args.debug_lines or args.debug_overlays,
            enable_particles=args.particles,
        ),
        client=FileClient(), device=args.device,
    ))
    w = app.world

    # Sponza light volume where present (NewLightvolTextures,
    # demo/src/lib.rs:135-192; box extents eyeballed for Sponza).
    lv_dir = os.path.join(ASSETS_DIR, "lighting", "uncompressed")
    if os.path.exists(os.path.join(lv_dir, "lightvol.ktx2")):
        w.insert_resource(NewLightvolTextures(
            urls=[os.path.join(lv_dir, n) for n in (
                "lightvol.ktx2", "lightvol_x.ktx2", "lightvol_y.ktx2", "lightvol_z.ktx2")],
            bottom_left=(-12.0, 0.0, -6.0),
            scale=(24.0, 12.0, 12.0),
        ))
    add_environment(w, args.ibl or os.path.join(ASSETS_DIR, "cubemaps", "noon.ktx2"))

    model_e = w.spawn(ModelUrl(args.model or default_model()))
    w.spawn(Instance(Similarity()), InstanceOf(model_e))
    if args.animated_model:
        anim_e = w.spawn(AnimatedModelUrl(args.animated_model))
        w.spawn(Instance(Similarity()), InstanceOf(anim_e))

    # Per-frame pushes come after BufferResetting clears the buffers.
    def push_debug_content(world):
        if args.particles:
            pb = world.resource(ParticleBuffer)
            for k in range(8):
                pb.push(
                    center=[1.5 * np.cos(0.8 * k), 1.0 + 0.25 * k, 1.5 * np.sin(0.8 * k)],
                    scale=[1.2, 1.2],
                    colour=[0.85, 0.85, 0.9],
                    emissive_colour=[0.4, 0.25, 0.1],
                )
        if args.debug_lines:
            lb = world.resource(LineBuffer)
            for g in range(-5, 6):
                lb.push([g, 0.02, -5], [g, 0.02, 5], 7)
                lb.push([-5, 0.02, g], [5, 0.02, g], 11)

    app.add_system(Stage.INSTANCE_BUFFERING, push_debug_content)

    if args.debug_overlays:
        from .ecs.debugging import push_bounding_boxes_to_lines, push_joints_to_lines

        app.add_system(Stage.INSTANCE_BUFFERING, push_joints_to_lines)
        app.add_system(Stage.INSTANCE_BUFFERING, push_bounding_boxes_to_lines)

    return app


def run(argv=None):
    """Render the demo's frames -> (app, info): info holds the PNG paths,
    each frame's host wall seconds and the size."""
    from .ecs.resources import CameraResource, FrameOutput
    from .render.rig import FlyCameraRig, parse_camera_script
    from .serve import wait_for_models
    from .utils.image import write_png

    args = parse_args(argv)
    width, height = map(int, args.size.split("x"))
    app = build_app(args)
    w = app.world
    os.makedirs(args.out, exist_ok=True)

    # Dolly-smoothed camera rig (CameraRig<Position+YawPitch+Smooth>,
    # demo/src/lib.rs:88-98, 374-397).
    rig = FlyCameraRig(position=(8.0, 2.0, 3.0), speed=6.0)
    rig.look_at((8.0, 2.0, 3.0), (0, 1.5, 0))
    rig.pos = rig.target_pos.copy()
    rig.yaw, rig.pitch = rig.target_yaw, rig.target_pitch
    script = None
    if args.path == "fly":
        if args.script:
            with open(args.script) as f:
                script = parse_camera_script(f.read())
        else:
            # default fly-through: push forward, sweep right, climb
            script = parse_camera_script(
                "0-30 w\n31-60 w+d mouse=1.2,0\n61-90 w mouse=-1.2,-0.4\n"
                "91-999 w+e mouse=0.6,0.3\n"
            )

    cam_res = w.resource(CameraResource)
    cam_res.camera.position, cam_res.camera.rotation = rig.update(0.0)
    wait_for_models(app)
    out = w.resource(FrameOutput)
    paths, frame_times = [], []
    dt = 1.0 / 60.0
    t_start = time.time()
    for n in range(args.frames):
        if script is not None:
            keys, mouse = script.get(n, (set(), (0.0, 0.0)))
            rig.apply_keys(keys, dt=dt, mouse=mouse)
        else:
            # orbit waypoints; the rig smooths between them
            ang = 0.35 + 0.1 * n
            eye = np.array([8.0 * np.cos(ang), 2.0, 8.0 * np.sin(ang)], np.float32)
            rig.look_at(eye, [0, 1.5, 0])
        cam_res.camera.position, cam_res.camera.rotation = rig.update(dt)
        t0 = time.time()
        app.update()
        img = out.image[0].cpu().numpy()
        frame_times.append(time.time() - t0)
        paths.append(os.path.join(args.out, f"frame_{n:03d}.png"))
        write_png(paths[-1], img)
    print(f"rendered {args.frames} frames {width}x{height} in {time.time() - t_start:.1f}s "
          f"(median frame {1e3 * np.median(frame_times):.1f}ms incl. host and readback)")
    print(f"frames in {args.out}/")
    return app, {"paths": paths, "frame_seconds": frame_times, "size": (width, height)}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())

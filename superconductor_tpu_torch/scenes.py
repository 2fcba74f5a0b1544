"""Scenes the port is driven with.

``headline_scene`` mirrors ``bench.py`` ``headline_scene`` (:461-511)
without jax: ``tests/fixtures/hero_helmet.glb`` through the full asset
pipeline, a static-placed gradient IBL cubemap sky, constant ambient SH,
the same camera and the same RenderConfig (t_cap 2^15, t_cap_anim 2^6,
p_cap 2^17). Capacities are not fitted yet (render/caps.py fit_caps).
"""

from __future__ import annotations

import os

import numpy as np

from ._host import (
    Camera,
    EnvBindings,
    Scene,
    default_ambient_sh,
    gradient_cubemap,
    load_model,
    make_uniforms,
    math3d,
)
from .render.draws import build_frame_state
from .render.frame import RenderConfig
from .scene.upload import scene_to_torch

HERO_GLB = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "fixtures", "hero_helmet.glb",
)


def _aim(cam, target, look_at, mat4_inverse, mat3_to_quat):
    """Point the camera at target (copy of bench.py:124)."""
    v = look_at(cam.position, target)
    cam.rotation = mat3_to_quat(mat4_inverse(v)[:3, :3])


def headline_host(width: int = 1920, height: int = 1080):
    """Host side of the headline scene -> (scene, model, uniforms, env,
    config): everything jax-free and device-free."""
    scene = Scene()
    with open(HERO_GLB, "rb") as f:
        model = load_model(scene, f.read(), name="hero_helmet")
    cubemap_base = gradient_cubemap(scene)
    cam = Camera(position=np.array([0.0, 0.25, 2.8], np.float32))
    _aim(cam, [0, 0, 0], math3d.look_at, math3d.mat4_inverse, math3d.mat3_to_quat)
    uniforms = make_uniforms(cam, width, height)
    env = EnvBindings.from_scene(scene, ambient_sh=default_ambient_sh())
    if env.ibl_cubemap_base != cubemap_base:
        raise RuntimeError("headline cubemap is not the scene's IBL cubemap")
    config = RenderConfig(
        width=width, height=height, t_cap=1 << 15, t_cap_anim=1 << 6,
        p_cap=1 << 17, raster="auto",
    )
    return scene, model, uniforms, env, config


def headline_scene(width: int = 1920, height: int = 1080, device="cuda"):
    """-> (dev, build, config, env) like the reference's headline_scene:
    dev is the scene's tables on `device`, build(angle) the FrameState of
    the helmet turned by `angle` radians about +y."""
    scene, model, uniforms, env, config = headline_host(width, height)
    dev = scene_to_torch(scene, device)

    def build(angle: float):
        sim = math3d.Similarity(
            rotation=math3d.quat_from_axis_angle([0, 1, 0], angle)
        )
        return build_frame_state(scene, [(model, sim)], uniforms, device=device)

    return dev, build, config, env

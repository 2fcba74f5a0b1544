"""Scenes the port is driven with.

``headline_scene`` mirrors ``bench.py`` ``headline_scene`` (:461-511)
without jax: ``tests/fixtures/hero_helmet.glb`` through the full asset
pipeline, a static-placed gradient IBL cubemap sky, constant ambient SH,
the same camera and the same RenderConfig (t_cap 2^15, t_cap_anim 2^6,
p_cap 2^17). Capacities are not fitted yet (render/caps.py fit_caps).

``quad_stack_setup`` is the k-buffer kernel's stress case: setup rows of
twelve quads stacked deeper than any K, with equal-depth ties.
``heavy_tile_setup`` is the raster kernel's: one tile holding thousands of
rows, each triangle repeated far from its first copy.

``clip_blend_scene`` is BASELINE config 3 (alpha-clipped + alpha-blended
materials) built from committed data only: the headline's helmet, sky and
SH, plus the all-passes sphere ring of ``bench.py`` ``all_passes_scene``
(:608-621, :667-673), with clip and blend on and lines and particles off.

``all_passes_scene`` is ``bench.py`` ``all_passes_scene`` (:534-679) with
what the repository holds: ``tests/fixtures/dense_terrain.glb`` (whose
material cannot take the interleaved pool, so the pool is partial and the
material-path partition engages), the sphere ring, 22 grid lines and 16
particles, every pass on. Its external assets (sponza_cubes, the bcn light
volume, noon.ktx2, the smoke textures) are left out: the sky is the
procedural gradient cubemap with constant ambient SH, as in the headline,
and the particles take the reference's procedural puff.

``lit_passes_scene`` is the all-passes scene lit as ``bench.py``
``all_passes_scene`` lights it (:583-606), from seeded data at the real
volume's dims: a 96x48x48 SH light volume in the bcn volume's probe box, a
lightmapped wall (``make_lightmapped_glb``'s quad) lit by four seeded SH
lightmaps, and two seeded smoke maps with an sRGB emissive LUT that half
of the particles read.

``stereo_animated_scene`` is ``bench.py`` ``bench_stereo_animated``
(:887-995, BASELINE configs 4 and 5): two 1080p eyes of six waving skinned
tubes (the animated vertex stage, joint palettes from the numpy FK every
frame) and six PBR spheres, all from procedural content.
"""

from __future__ import annotations

import json
import math
import os
import struct
from types import SimpleNamespace

import numpy as np
import torch

from . import math3d
from .assets.models import load_model
from .ops.geometry import TriangleSetup, _setup_from_clip
from .render.camera import Camera, make_stereo_uniforms, make_uniforms
from .render.draws import build_frame_state, pack_lines, pack_particles
from .render.env import EnvBindings
from .render.frame import RenderConfig
from .scene.scene import (
    BLEND_ALPHA_BLENDED,
    BLEND_ALPHA_CLIPPED,
    MAT_DOUBLE_SIDED,
    TEXFLAG_SRGB,
    WRAP_CLAMP,
    Scene,
    build_mip_chain,
)
from .scene.upload import scene_to_torch
from .utils.procgen import (
    add_pbr_sphere,
    add_skinned_tube,
    checker_texture,
    default_ambient_sh,
    gradient_cubemap,
    wave_joint_palettes,
)

# The host layer the scenes are built with: the port's own modules. Any
# namespace with these names and the same behaviour builds the same scene
# (the parity tests pass the reference's, to hold the two side by side).
HOST = SimpleNamespace(
    Scene=Scene, load_model=load_model, gradient_cubemap=gradient_cubemap,
    add_pbr_sphere=add_pbr_sphere, checker_texture=checker_texture,
    default_ambient_sh=default_ambient_sh, build_mip_chain=build_mip_chain,
    Camera=Camera, make_uniforms=make_uniforms, EnvBindings=EnvBindings,
    math3d=math3d, add_skinned_tube=add_skinned_tube,
    wave_joint_palettes=wave_joint_palettes, make_stereo_uniforms=make_stereo_uniforms,
)

_FIXTURES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "fixtures"
)
HERO_GLB = os.path.join(_FIXTURES, "hero_helmet.glb")
TERRAIN_GLB = os.path.join(_FIXTURES, "dense_terrain.glb")


def _aim(cam, target, m3):
    """Point the camera at target (copy of bench.py:124)."""
    v = m3.look_at(cam.position, target)
    cam.rotation = m3.mat3_to_quat(m3.mat4_inverse(v)[:3, :3])


def headline_host(width: int = 1920, height: int = 1080, host=HOST):
    """Host side of the headline scene -> (scene, model, uniforms, env,
    config): everything device-free, built with `host`'s modules."""
    scene = host.Scene()
    with open(HERO_GLB, "rb") as f:
        model = host.load_model(scene, f.read(), name="hero_helmet")
    cubemap_base = host.gradient_cubemap(scene)
    cam = host.Camera(position=np.array([0.0, 0.25, 2.8], np.float32))
    _aim(cam, [0, 0, 0], host.math3d)
    uniforms = host.make_uniforms(cam, width, height)
    env = host.EnvBindings.from_scene(scene, ambient_sh=host.default_ambient_sh())
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


# the small clip_blend frame of the CPU parity tests, its golden and the
# card's check against it: spheres cut to 32 stacks and slices
CLIP_BLEND_SMALL = dict(width=256, height=128, stacks=32)


def _clip_checker(checker_texture) -> np.ndarray:
    """add_pbr_sphere's albedo checker with alpha 0 on its dark squares, so
    the clip resolve sees failing layers (the procgen checker is opaque)."""
    img = checker_texture()
    dark = (img[..., :3] == np.array((200, 60, 40), np.uint8)).all(axis=-1)
    img[..., 3] = np.where(dark, 0, 255).astype(np.uint8)
    return img


def _sphere_ring(scene, host, n_spheres: int, stacks: int) -> list:
    """The all-passes sphere ring's models (bench.py:610-621): every 5th
    sphere alpha-clipped (checker alpha 0 on the dark squares, double-sided
    so holes show the inside), every 7th blended (base colour alpha 0.6),
    the rest opaque."""
    clip_albedo = None
    spheres = []
    for i in range(n_spheres):
        m = host.add_pbr_sphere(scene, stacks=stacks, slices=stacks, name=f"sphere{i}")
        mat = scene.materials[m.primitives[0].material]
        if i % 5 == 1:
            if clip_albedo is None:
                clip_albedo = scene.textures.add_texture(
                    host.build_mip_chain(_clip_checker(host.checker_texture)),
                    flags=TEXFLAG_SRGB,
                )
            mat.albedo_tex = clip_albedo
            mat.flags |= MAT_DOUBLE_SIDED
            mat.blend_mode = BLEND_ALPHA_CLIPPED
            m.primitives[0].blend_mode = BLEND_ALPHA_CLIPPED
            m.primitives[0].double_sided = True
        elif i % 7 == 2:
            mat.blend_mode = BLEND_ALPHA_BLENDED
            mat.base_color_factor = (1.0, 1.0, 1.0, 0.6)
            m.primitives[0].blend_mode = BLEND_ALPHA_BLENDED
        spheres.append(m)
    return spheres


def _ring_instances(spheres: list, angle: float, m3) -> list:
    """(model, Similarity) of each sphere on the ring (6 cos a, 1.3,
    3 sin a), turned by `angle` about +y (bench.py:667-673)."""
    rot = m3.quat_from_axis_angle([0, 1, 0], angle)
    out = []
    for i, m in enumerate(spheres):
        a = 2.0 * np.pi * i / len(spheres)
        out.append((m, m3.Similarity(
            translation=[6.0 * np.cos(a), 1.3, 3.0 * np.sin(a)], rotation=rot,
        )))
    return out


def clip_blend_host(width: int = 1920, height: int = 1080, n_spheres: int = 8,
                    stacks: int = 88, host=HOST):
    """Host side of the clip_blend scene -> (scene, instances, uniforms,
    env, config), device-free, built with `host`'s modules.
    `instances(angle)` lists the (model, Similarity) draws with the spheres
    turned by `angle` about +y.

    The ring: every 5th sphere alpha-clipped (checker alpha 0 on the dark
    squares, double-sided so holes show the inside), every 7th blended
    (base colour alpha 0.6), the rest opaque, at (6 cos a, 1.3, 3 sin a)
    around the helmet. The camera looks down the ring's +z side past the
    blended sphere (index 2) onto the helmet, with clipped sphere 1 in
    view; sky stays above half the frame."""
    m3 = host.math3d
    scene = host.Scene()
    with open(HERO_GLB, "rb") as f:
        hero = host.load_model(scene, f.read(), name="hero_helmet")
    cubemap_base = host.gradient_cubemap(scene)
    spheres = _sphere_ring(scene, host, n_spheres, stacks)

    cam = host.Camera(position=np.array([0.8, 1.7, 7.5], np.float32))
    _aim(cam, [0.3, 0.8, 0], m3)
    uniforms = host.make_uniforms(cam, width, height)
    env = host.EnvBindings.from_scene(scene, ambient_sh=host.default_ambient_sh())
    if env.ibl_cubemap_base != cubemap_base:
        raise RuntimeError("clip_blend cubemap is not the scene's IBL cubemap")
    config = RenderConfig(
        width=width, height=height, t_cap=1 << 18, t_cap_anim=1 << 6,
        p_cap=1 << 19, raster="auto", enable_clip=True, enable_blend=True,
    )

    def instances(angle: float):
        return [(hero, m3.Similarity())] + _ring_instances(spheres, angle, m3)

    return scene, instances, uniforms, env, config


def clip_blend_scene(width: int = 1920, height: int = 1080, device="cuda",
                     n_spheres: int = 8, stacks: int = 88):
    """-> (dev, build, config, env) of the clip_blend scene, as
    headline_scene: build(angle) turns the spheres by `angle` about +y."""
    scene, instances, uniforms, env, config = clip_blend_host(
        width, height, n_spheres, stacks
    )
    dev = scene_to_torch(scene, device)

    def build(angle: float):
        return build_frame_state(scene, instances(angle), uniforms, device=device)

    return dev, build, config, env


# the small all-passes frame of the CPU parity tests, its golden and the
# card's check against it: spheres cut to 32 stacks and slices, LODs
# selected for a 128-px-tall screen
ALL_PASSES_SMALL = dict(width=256, height=128, stacks=32, lod_screen_height=128)


ALL_PASSES_EYE = (8.0, 2.5, 3.0)  # the all-passes camera, aimed at ALL_PASSES_TARGET
ALL_PASSES_TARGET = (0.0, 1.2, 0.0)
DEEP_SEED = 43


def deep_particle_stack(n: int) -> list:
    """`n` particles stacked along the all-passes camera's view ray, at
    seeded fractions 0.1-0.45 of the way to its target (in front of the
    ring and the terrain), the second at the first's depth: a pixel near
    the frame's centre holds every one of them (particle_layers_needed
    >= n)."""
    eye, target = np.array(ALL_PASSES_EYE), np.array(ALL_PASSES_TARGET)
    ts = np.sort(np.random.default_rng(DEEP_SEED).uniform(0.1, 0.45, size=n))
    if n > 1:
        ts[1] = ts[0]
    return [
        {
            "center": list(eye + t * (target - eye)),
            "scale": [0.3, 0.3],
            "colour": [0.5 + 0.5 * t, 0.6, 0.9 - t],
            "emissive_colour": [0.2, 0.1, 0.05],
        }
        for t in ts
    ]


def all_passes_overlays(deep_particles: int = 0) -> dict:
    """The all-passes frame's 22 grid lines (colour ids 0-21) and 16
    particles (bench.py:641-658), as build_frame_state keywords; with
    `deep_particles`, that many more stacked along the view ray
    (deep_particle_stack)."""
    lines = pack_lines(
        [[[g, 0.02, -5], [g, 0.02, 5]] for g in range(-5, 6)]
        + [[[-5, 0.02, g], [5, 0.02, g]] for g in range(-5, 6)],
        list(range(22)),
    )
    particles = pack_particles([
        {
            "center": [3.0 * np.cos(0.8 * k), 1.0 + 0.2 * k, 3.0 * np.sin(0.8 * k)],
            "scale": [1.5, 1.5],
            "colour": [0.9, 0.9, 0.95],
            "emissive_colour": [0.3, 0.2, 0.1],
        }
        for k in range(16)
    ] + deep_particle_stack(deep_particles))
    return {"lines": lines, "particles": particles}


def all_passes_host(width: int = 1920, height: int = 1080, n_spheres: int = 8,
                    stacks: int = 88, lod_screen_height: int = 1080, host=HOST,
                    deep_particles: int = 0):
    """Host side of the all-passes scene -> (scene, instances, uniforms,
    env, config, draw_kw), device-free, built with `host`'s modules.
    `instances(angle)` lists the (model, Similarity) draws -- the terrain
    at translation (0, -0.6, 0), scale 1.6, and the ring turned by `angle`
    about +y -- and `draw_kw` the build_frame_state keywords: the lines,
    the particles (deep_particles more along the view ray) and the LOD
    screen height."""
    m3 = host.math3d
    scene = host.Scene()
    with open(TERRAIN_GLB, "rb") as f:
        terrain = host.load_model(scene, f.read(), name="dense_terrain")
    cubemap_base = host.gradient_cubemap(scene)
    spheres = _sphere_ring(scene, host, n_spheres, stacks)
    scene._materials_dirty = True

    cam = host.Camera(position=np.array(ALL_PASSES_EYE, np.float32))
    _aim(cam, list(ALL_PASSES_TARGET), m3)
    uniforms = host.make_uniforms(cam, width, height)
    env = host.EnvBindings.from_scene(scene, ambient_sh=host.default_ambient_sh())
    if env.ibl_cubemap_base != cubemap_base:
        raise RuntimeError("all-passes cubemap is not the scene's IBL cubemap")
    config = RenderConfig(
        width=width, height=height, t_cap=1 << 18, t_cap_anim=1 << 6,
        p_cap=1 << 19, raster="auto", enable_clip=True, enable_blend=True,
        enable_lines=True, enable_particles=True,
    )

    def instances(angle: float):
        ground = m3.Similarity(translation=[0.0, -0.6, 0.0], scale=1.6)
        return [(terrain, ground)] + _ring_instances(spheres, angle, m3)

    draw_kw = dict(all_passes_overlays(deep_particles), screen_height=lod_screen_height)
    return scene, instances, uniforms, env, config, draw_kw


def all_passes_scene(width: int = 1920, height: int = 1080, device="cuda",
                     n_spheres: int = 8, stacks: int = 88, lod_screen_height: int = 1080,
                     deep_particles: int = 0):
    """-> (dev, build, config, env) of the all-passes scene, as
    headline_scene: build(angle) turns the spheres by `angle` about +y."""
    scene, instances, uniforms, env, config, draw_kw = all_passes_host(
        width, height, n_spheres, stacks, lod_screen_height, deep_particles=deep_particles
    )
    dev = scene_to_torch(scene, device)

    def build(angle: float):
        return build_frame_state(scene, instances(angle), uniforms, device=device, **draw_kw)

    return dev, build, config, env


# the small lit frame of the CPU parity tests, its golden and the card's
# check against it: the all-passes cut, with 256^2 lightmaps and smoke maps
LIT_PASSES_SMALL = dict(ALL_PASSES_SMALL, lightmap_size=256, smoke_size=256)

# bench.py:583-592: the bcn volume's probe box (ProbesArrayInfo centre
# (0, 6, 0), scale (24, 12, 12)) and dims (tests/test_ktx2.py:22-25)
LIGHTVOL_BOTTOM_LEFT = (-12.0, 0.0, -6.0)
LIGHTVOL_SCALE = (24.0, 12.0, 12.0)
LIGHTVOL_DIMS = (96, 48, 48)  # w, h, z
# the numpy seed of the lit scene's volume, lightmaps, smoke maps and LUT
LIT_SEED = 7


def lightmapped_quad_glb() -> bytes:
    """A 2x2 quad in the z = 0 plane facing +z, with TEXCOORD_0 over [0, 1]
    and TEXCOORD_1 (the lightmap uv, which marks it lightmapped) over
    [0.2, 0.8], and one untextured material (the reference's
    tests/test_lightmap.py make_lightmapped_glb)."""
    pos = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    uv2 = np.array([[0.2, 0.2], [0.8, 0.2], [0.8, 0.8], [0.2, 0.8]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    blob = pos.tobytes() + uv.tobytes() + uv2.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "TEXCOORD_0": 1, "TEXCOORD_1": 2},
            "indices": 3, "material": 0,
        }]}],
        "materials": [{"pbrMetallicRoughness": {"metallicFactor": 0.0}}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3",
             "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC2"},
            {"bufferView": 2, "componentType": 5126, "count": 4, "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 48},
            {"buffer": 0, "byteOffset": 48, "byteLength": 32},
            {"buffer": 0, "byteOffset": 80, "byteLength": 32},
            {"buffer": 0, "byteOffset": 112, "byteLength": 12},
        ],
        "buffers": [{"byteLength": len(blob)}],
    }
    j = json.dumps(doc).encode()
    j += b" " * (-len(j) % 4)
    blob += b"\0" * (-len(blob) % 4)
    out = struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(j) + 8 + len(blob))
    out += struct.pack("<II", len(j), 0x4E4F534A) + j
    out += struct.pack("<II", len(blob), 0x004E4942) + blob
    return out


def _glb(doc: dict, blob: bytes) -> bytes:
    """A GLB container of a glTF document and its binary chunk."""
    j = json.dumps(doc).encode()
    j += b" " * (-len(j) % 4)
    blob += b"\0" * (-len(blob) % 4)
    out = struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(j) + 8 + len(blob))
    out += struct.pack("<II", len(j), 0x4E4F534A) + j
    out += struct.pack("<II", len(blob), 0x004E4942) + blob
    return out


def box_glb(alpha_mode: str = None, base_color=(1.0, 0.2, 0.1, 1.0)) -> bytes:
    """A unit cube with one unlit material (the reference's
    tests/conftest.py make_box_glb): 8 corners, 12 triangles wound CCW
    outward; alpha_mode None (opaque), 'MASK' or 'BLEND'."""
    p = np.array([[-0.5, -0.5, -0.5], [0.5, -0.5, -0.5], [0.5, 0.5, -0.5],
                  [-0.5, 0.5, -0.5], [-0.5, -0.5, 0.5], [0.5, -0.5, 0.5],
                  [0.5, 0.5, 0.5], [-0.5, 0.5, 0.5]], np.float32)
    tris = np.array([[4, 5, 6], [4, 6, 7], [1, 0, 3], [1, 3, 2], [5, 1, 2], [5, 2, 6],
                     [0, 4, 7], [0, 7, 3], [7, 6, 2], [7, 2, 3], [0, 1, 5], [0, 5, 4]],
                    np.uint16)
    pos_bytes, idx_bytes = p.tobytes(), tris.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0}, "indices": 1, "material": 0}
        ]}],
        "materials": [{
            "pbrMetallicRoughness": {
                "baseColorFactor": list(base_color),
                "metallicFactor": 0.0,
                "roughnessFactor": 1.0,
            },
            "extensions": {"KHR_materials_unlit": {}},
            **({"alphaMode": alpha_mode} if alpha_mode else {}),
        }],
        "extensionsUsed": ["KHR_materials_unlit"],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 8, "type": "VEC3",
             "min": p.min(0).tolist(), "max": p.max(0).tolist()},
            {"bufferView": 1, "componentType": 5123, "count": 36, "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(pos_bytes)},
            {"buffer": 0, "byteOffset": len(pos_bytes), "byteLength": len(idx_bytes)},
        ],
        "buffers": [{"byteLength": len(pos_bytes) + len(idx_bytes)}],
    }
    return _glb(doc, pos_bytes + idx_bytes)


def skinned_ribbon_glb() -> bytes:
    """A skinned, animated ribbon (the reference's tests/conftest.py
    make_skinned_glb): two quads stacked from y = 0 to 2, x = +-0.1, bound
    to two joints (joint 1 at y = 1), with one unlit green double-sided
    material; joint 1 turns 90 degrees about z over 1 s (LINEAR)."""
    pos = np.array([[-0.1, 0, 0], [0.1, 0, 0], [-0.1, 1, 0], [0.1, 1, 0],
                    [-0.1, 2, 0], [0.1, 2, 0]], np.float32)
    tris = np.array([[0, 1, 3], [0, 3, 2], [2, 3, 5], [2, 5, 4]], np.uint16)
    joints = np.array([[0, 0, 0, 0]] * 2 + [[0, 1, 0, 0]] * 2 + [[1, 0, 0, 0]] * 2,
                      np.uint16)
    weights = np.array([[1, 0, 0, 0]] * 2 + [[0.5, 0.5, 0, 0]] * 2 + [[1, 0, 0, 0]] * 2,
                       np.float32)
    # inverse bind matrices, column-major: joint 0 identity, joint 1
    # translates y by -1 (flat element 13)
    ibm = np.stack([np.eye(4, dtype=np.float32)] * 2)
    ibm[1][3][1] = -1.0
    s, c = math.sin(math.pi / 4), math.cos(math.pi / 4)
    rots = np.array([[0, 0, 0, 1], [0, 0, s, c]], np.float32)
    times = np.array([0.0, 1.0], np.float32)

    blob = b""
    views, accessors = [], []

    def add(data, ctype, count, type_, **extra):
        nonlocal blob
        b = data.tobytes()
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(b)})
        blob += b + b"\0" * (-len(b) % 4)
        accessors.append({"bufferView": len(views) - 1, "componentType": ctype,
                          "count": count, "type": type_, **extra})
        return len(accessors) - 1

    a_pos = add(pos, 5126, 6, "VEC3", min=pos.min(0).tolist(), max=pos.max(0).tolist())
    a_idx = add(tris, 5123, 12, "SCALAR")
    a_joints = add(joints, 5123, 6, "VEC4")
    a_weights = add(weights, 5126, 6, "VEC4")
    a_ibm = add(ibm.reshape(2, 16), 5126, 2, "MAT4")
    a_times = add(times, 5126, 2, "SCALAR", min=[0.0], max=[1.0])
    a_rots = add(rots, 5126, 2, "VEC4")
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [
            {"mesh": 0, "skin": 0, "children": [1]},
            {"children": [2]},  # joint 0 at the origin
            {"translation": [0, 1, 0]},  # joint 1
        ],
        "skins": [{"joints": [1, 2], "inverseBindMatrices": a_ibm}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": a_pos, "JOINTS_0": a_joints, "WEIGHTS_0": a_weights},
            "indices": a_idx,
            "material": 0,
        }]}],
        "materials": [{
            "pbrMetallicRoughness": {"baseColorFactor": [0, 1, 0, 1]},
            "extensions": {"KHR_materials_unlit": {}},
            "doubleSided": True,
        }],
        "extensionsUsed": ["KHR_materials_unlit"],
        "animations": [{
            "samplers": [{"input": a_times, "interpolation": "LINEAR", "output": a_rots}],
            "channels": [{"sampler": 0, "target": {"node": 2, "path": "rotation"}}],
        }],
        "accessors": accessors,
        "bufferViews": views,
        "buffers": [{"byteLength": len(blob)}],
    }
    return _glb(doc, blob)


def _sh_set(rng, shape) -> list:
    """Four seeded SH images (L0, Lx, Ly, Lz) of `shape` (..., h, w): each
    channel a smooth field (a sinusoid of seeded frequency and phase along
    the texel grid) under 10% seeded noise. L0 is HDR in [0, 2]; the L1
    bands are 0..1-encoded at k/255, as an RGBA8 decode gives them; alpha
    is 1."""
    axes = np.meshgrid(*[np.linspace(0.0, 1.0, n, dtype=np.float32) for n in shape],
                       indexing="ij")

    def field():
        f = rng.uniform(0.5, 2.0, size=len(shape))
        phase = sum(2.0 * np.pi * fi * a for fi, a in zip(f, axes)) + rng.uniform(0, 2 * np.pi)
        return 0.5 + 0.45 * np.sin(phase) + 0.05 * rng.uniform(-1.0, 1.0, size=shape)

    out = []
    for band in range(4):
        img = np.ones(shape + (4,), np.float32)
        for c in range(3):
            img[..., c] = field()
        if band == 0:
            img[..., :3] *= 2.0
        else:
            img[..., :3] = np.rint(img[..., :3] * 255.0) / np.float32(255.0)
        out.append(img)
    return out


def _smoke_maps(rng, size: int) -> list:
    """Two seeded size^2 smoke maps, u8: a = (left, bottom, front,
    emissive), b = (right, top, back, alpha), each a radial puff under
    seeded noise."""
    c = (np.arange(size, dtype=np.float32) + 0.5) / size - 0.5
    puff = np.clip(1.0 - 2.0 * np.hypot(c[None, :], c[:, None]), 0.0, 1.0)
    return [
        np.rint(255.0 * puff[..., None] * rng.uniform(0.4, 1.0, size=(size, size, 4)))
        .astype(np.uint8)
        for _ in range(2)
    ]


def _emissive_lut(rng) -> np.ndarray:
    """A 256x16 sRGB-encoded emissive ramp under seeded noise, u8."""
    x = np.linspace(0.0, 1.0, 256, dtype=np.float32)
    ramp = np.stack([x, x ** 1.5, x ** 3, np.ones_like(x)], axis=-1)
    lut = ramp[None] * rng.uniform(0.8, 1.0, size=(16, 256, 4))
    return np.rint(255.0 * np.clip(lut, 0.0, 1.0)).astype(np.uint8)


def lit_passes_host(width: int = 1920, height: int = 1080, n_spheres: int = 8,
                    stacks: int = 88, lod_screen_height: int = 1080,
                    lightmap_size: int = 1024, smoke_size: int = 1024, host=HOST):
    """Host side of the lit scene -> (scene, instances, uniforms, env,
    config, draw_kw), as all_passes_host, whose scene it extends with what
    bench.py's all_passes_scene loads from files not in the repository, in
    seeded data (numpy seed LIT_SEED):

    - the light volume: four 96x48x48 SH volumes (the bcn volume's dims)
      as HDR textures whose mip entries are the z layers, WRAP_CLAMP (the
      layout of environment._load_volume_texture), in the bcn probe box;
    - a lightmapped wall: lightmapped_quad_glb scaled to 12 x 12, behind
      the sphere ring and turned to face the camera, lit by four
      lightmap_size^2 SH lightmaps (the Sponza lightmaps' real dims are not
      in the repository);
    - smoke: two smoke_size^2 smoke maps (equal dims and wrap, so the smoke
      pool is published) and a 256x16 sRGB LUT, in the LDR pool with
      WRAP_CLAMP (the burst textures' real dims are not in the repository).

    One data change from bench.py:641-658: the odd particles set
    use_emissive_lut with lut_y (k + 0.5) / 16, so the LUT is read. As in
    the bench, the environment has no ambient SH."""
    scene, base_instances, uniforms, _env, config, draw_kw = all_passes_host(
        width, height, n_spheres, stacks, lod_screen_height, host=host
    )
    m3 = host.math3d
    rng = np.random.default_rng(LIT_SEED)
    w, h, z = LIGHTVOL_DIMS
    lv_ids = [scene.textures_hdr.add_texture(list(vol), wrap=WRAP_CLAMP)
              for vol in _sh_set(rng, (z, h, w))]
    scene.lightvol = {
        "tex_ids": lv_ids, "z_layers": z,
        "bottom_left": np.asarray(LIGHTVOL_BOTTOM_LEFT, np.float32),
        "scale": np.asarray(LIGHTVOL_SCALE, np.float32),
    }
    uniforms.probes_bottom_left = scene.lightvol["bottom_left"]
    uniforms.probes_scale = scene.lightvol["scale"]

    wall = host.load_model(scene, lightmapped_quad_glb(), name="lightmapped_wall")
    scene.lightmap_tex = [scene.textures_hdr.add_texture([img], wrap=WRAP_CLAMP)
                          for img in _sh_set(rng, (lightmap_size, lightmap_size))]

    a, b = _smoke_maps(rng, smoke_size)
    scene.smoke_tex = (
        scene.textures.add_texture([a], wrap=WRAP_CLAMP),
        scene.textures.add_texture([b], wrap=WRAP_CLAMP),
        scene.textures.add_texture([_emissive_lut(rng)], wrap=WRAP_CLAMP, flags=TEXFLAG_SRGB),
    )
    scene._materials_dirty = True

    particles = draw_kw["particles"]
    particles["use_emissive_lut"][1:16:2] = 1
    particles["lut_y"][1:16:2] = (np.arange(1, 16, 2, dtype=np.float32) + 0.5) / 16.0

    env = host.EnvBindings.from_scene(scene)
    if env.lightvol_wh is None or env.lightmap_wh is None or env.smoke_static is None:
        raise RuntimeError("lit_passes environment is not bound to the scene's tables")
    wall_pos = np.array([-7.8, 3.0, -3.0], np.float32)
    to_cam = np.array(ALL_PASSES_EYE, np.float32) - wall_pos
    wall_sim = m3.Similarity(
        translation=wall_pos.tolist(), scale=6.0,
        rotation=m3.quat_from_axis_angle([0, 1, 0], float(np.arctan2(to_cam[0], to_cam[2]))),
    )

    def instances(angle: float):
        return base_instances(angle) + [(wall, wall_sim)]

    return scene, instances, uniforms, env, config, draw_kw


def lit_passes_scene(width: int = 1920, height: int = 1080, device="cuda", **kw):
    """-> (dev, build, config, env) of the lit scene, as headline_scene:
    build(angle) turns the spheres by `angle` about +y. `kw`:
    lit_passes_host's sizes."""
    scene, instances, uniforms, env, config, draw_kw = lit_passes_host(width, height, **kw)
    dev = scene_to_torch(scene, device)

    def build(angle: float):
        return build_frame_state(scene, instances(angle), uniforms, device=device, **draw_kw)

    return dev, build, config, env


# the stereo-animated frame of the golden and the card's check against it:
# spheres cut to 32 stacks and slices; and the CPU parity tests' small one:
# two tubes of 8 segments x 6 slices and two 8-stack spheres
STEREO_SMALL = dict(width=256, height=128, stacks=32)
STEREO_TINY = dict(width=128, height=64, n_tubes=2, n_spheres=2, segments=8, slices=6,
                   stacks=8)


def stereo_animated_host(width: int = 1920, height: int = 1080, n_tubes: int = 6,
                         n_spheres: int = 6, segments: int = 64, slices: int = 48,
                         stacks: int = 88, host=HOST):
    """Host side of the stereo-animated scene -> (scene, frame_inputs,
    uniforms, env, config), device-free, built with `host`'s modules
    (bench.py:887-995). One skinned tube and one PBR sphere model, each
    instanced: the tubes on a circle of radius 3.2, the spheres of radius
    5.5 at height 1.2 between them. `frame_inputs(t)` -> (instances, joint
    palettes) at time t: the spheres turned by 0.3 t about +y, tube i
    waving at phase t + 0.7 i (8 joints, amplitude 0.45). The eyes sit
    0.032 either side of (0, 1.4, 7), looking at (0, 1, 0)."""
    m3 = host.math3d
    scene = host.Scene()
    tube = host.add_skinned_tube(scene, segments=segments, slices=slices, name="tube")
    sphere = host.add_pbr_sphere(scene, stacks=stacks, slices=stacks, name="st_sphere")
    cubemap_base = host.gradient_cubemap(scene)
    env = host.EnvBindings.from_scene(scene, ambient_sh=host.default_ambient_sh())
    if env.ibl_cubemap_base != cubemap_base:
        raise RuntimeError("stereo cubemap is not the scene's IBL cubemap")

    center = np.array([0.0, 1.0, 0.0], np.float32)
    eye_mid = np.array([0.0, 1.4, 7.0], np.float32)
    rot = m3.mat3_to_quat(m3.mat4_inverse(m3.look_at(eye_mid, center))[:3, :3])
    half_ipd = np.array([0.032, 0.0, 0.0], np.float32)
    left = host.Camera(position=eye_mid - half_ipd, rotation=rot)
    right = host.Camera(position=eye_mid + half_ipd, rotation=rot)
    lu = host.make_uniforms(left, width, height)
    ru = host.make_uniforms(right, width, height)
    uniforms = host.make_stereo_uniforms(
        lu.view[0], ru.view[0], lu.projection[0], ru.projection[0],
        lu.eye[0], ru.eye[0], left.rotation, right.rotation,
    )
    config = RenderConfig(
        width=width, height=height, num_views=2,
        t_cap=1 << 17, t_cap_anim=1 << 16, p_cap=1 << 19, raster="auto",
    )

    def frame_inputs(t: float):
        rot_i = m3.quat_from_axis_angle([0, 1, 0], 0.3 * t)
        pals = host.wave_joint_palettes(
            t + 0.7 * np.arange(n_tubes, dtype=np.float32), 8, amp=0.45
        )
        instances = []
        for i in range(n_tubes):
            a = 2.0 * np.pi * i / n_tubes
            instances.append((tube, m3.Similarity(
                translation=[3.2 * np.cos(a), 0.0, 3.2 * np.sin(a)])))
        for i in range(n_spheres):
            a = 2.0 * np.pi * (i + 0.5) / n_spheres
            instances.append((sphere, m3.Similarity(
                translation=[5.5 * np.cos(a), 1.2, 5.5 * np.sin(a)], rotation=rot_i)))
        return instances, {i: pals[i] for i in range(n_tubes)}

    return scene, frame_inputs, uniforms, env, config


def stereo_animated_scene(width: int = 1920, height: int = 1080, device="cuda", **kw):
    """-> (dev, build, config, env) of the stereo-animated scene, as
    headline_scene: build(t) is the FrameState at time t, its joint
    palettes sampled on the host. `kw`: stereo_animated_host's counts."""
    scene, frame_inputs, uniforms, env, config = stereo_animated_host(width, height, **kw)
    dev = scene_to_torch(scene, device)

    def build(t: float):
        instances, palettes = frame_inputs(t)
        return build_frame_state(scene, instances, uniforms, joint_palettes=palettes,
                                 device=device)

    return dev, build, config, env


def quad_stack_setup(width: int, height: int, device="cuda",
                     reverse_z: bool = True, extra: int = 9) -> TriangleSetup:
    """Setup rows of 3 + `extra` (twelve by default) double-sided quads
    stacked over one region that straddles tile borders: three exact copies
    of one quad (equal z at every pixel), quads at mixed homogeneous w, and
    the rest at depths drawn from a numpy seed, so a pixel holds up to 3 +
    `extra` accepted fragments."""
    rng = np.random.default_rng(21)
    quads = [((-0.6, -0.5, 0.5, 0.6), 0.4, 1.0)] * 3
    for i in range(extra):
        x0, y0 = rng.uniform(-0.8, -0.3, size=2)
        x1, y1 = rng.uniform(0.2, 0.8, size=2)
        z = [0.3, 0.55, 0.55][i % 3] if i < 6 else float(rng.uniform(0.1, 0.9))
        quads.append(((x0, y0, x1, y1), z, 1.0 + (i % 2)))
    clip = []
    for (x0, y0, x1, y1), z, w in quads:
        z = z if reverse_z else 1.0 - z
        pts = [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
        for tri in ((0, 1, 2), (0, 2, 3)):
            clip.append([[pts[v][0] * w, pts[v][1] * w, z * w, w] for v in tri])
    return _clip_setup(clip, width, height, device)


def heavy_tile_setup(width: int, height: int, device="cuda",
                     reverse_z: bool = True, n: int = 1100) -> TriangleSetup:
    """Setup rows of 2n small double-sided triangles inside the 32x128 tile
    at pixel (128, 32): n triangles drawn from a numpy seed (half of them
    with every vertex on a pixel centre, depths from a set of three values,
    homogeneous w 1 or 2), then the same n again in shuffled order. The
    tile holds all 2n rows, and every triangle's exact copy, equal in z at
    every pixel, lies about n rows away, so a split of the tile's rows puts
    the two in different parts. Needs width >= 256 and height >= 64."""
    rng = np.random.default_rng(33)
    clip = []
    for i in range(n):
        cx, cy = rng.uniform(131.0, 253.0), rng.uniform(35.0, 61.0)
        pts = [(cx + dx, cy + dy) for dx, dy in rng.uniform(-3.0, 3.0, size=(3, 2))]
        if i % 2:
            pts = [(np.floor(x) + 0.5, np.floor(y) + 0.5) for x, y in pts]
        z = (0.2, 0.45, 0.7)[i % 3] if i % 4 else float(rng.uniform(0.1, 0.9))
        z = z if reverse_z else 1.0 - z
        w = 1.0 + (i % 2)
        clip.append([[(x / (width * 0.5) - 1.0) * w, (1.0 - y / (height * 0.5)) * w,
                      z * w, w] for x, y in pts])
    clip = clip + [clip[j] for j in rng.permutation(n)]
    return _clip_setup(clip, width, height, device)


def _clip_setup(clip: list, width: int, height: int, device) -> TriangleSetup:
    """TriangleSetup of double-sided triangles given as clip-space corner
    lists (T, 3, 4), all valid."""
    clip = torch.tensor(clip, dtype=torch.float32, device=device)
    t = clip.shape[0]
    ones = torch.ones(t, dtype=torch.bool, device=device)
    setup, valid, bbox = _setup_from_clip(clip, ones, ones, width, height, False)
    return TriangleSetup(
        setup=setup, tri_id=torch.arange(t, dtype=torch.int32, device=device),
        inst_id=torch.zeros(t, dtype=torch.int32, device=device), bbox=bbox,
        valid=valid, num_valid=valid.sum(dtype=torch.int32),
    )

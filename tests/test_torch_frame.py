"""The ported slice end to end: the hero frame at 256x128 through the
port against the reference's render_frame_stats (raster="pallas", the
Pallas kernel in interpret mode on CPU) with the same config; the
reference's two PNG goldens rendered by the port; the RenderConfig
contract; shade_row_pad and the wide mq3 rows; fit_caps against bench.fit_caps; and a
jax-free process rendering a frame."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import bench
from superconductor_tpu.math3d import Similarity, quat_from_axis_angle
from superconductor_tpu.render import frame as ref_frame
from superconductor_tpu.render.draws import build_frame_state as ref_build
from superconductor_tpu.utils.metrics import psnr
from superconductor_tpu_torch import math3d as port_math3d
from superconductor_tpu_torch.render import caps as port_caps
from superconductor_tpu_torch.render import frame as port_frame
from superconductor_tpu_torch.render.draws import build_frame_state as port_build
from superconductor_tpu_torch.render.frame import RenderConfig
from superconductor_tpu_torch.scene.upload import scene_to_torch
from superconductor_tpu_torch.scenes import headline_host
from test_torch_host import REF_HOST

# The test workers share the CPU: torch's default of a thread per core in
# each of them oversubscribes it many times over.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERO_GOLDEN = os.path.join(REPO, "tests", "goldens", "torch_hero_256x128.npz")


def _port_frame_inputs(width, height, angle):
    """(scene tables, FrameState, env) of the port's own headline scene on
    the CPU, the helmet turned by `angle`."""
    scene, model, uniforms, env, _ = headline_host(width, height)
    sim = port_math3d.Similarity(rotation=port_math3d.quat_from_axis_angle([0, 1, 0], angle))
    return (scene_to_torch(scene, "cpu"),
            port_build(scene, [(model, sim)], uniforms, device="cpu"), env)


def _ref_config(config):
    return ref_frame.RenderConfig(**{**dataclasses.asdict(config), "raster": "pallas"})


@pytest.mark.parametrize("opaque_px_cap", [None, 1 << 14])
def test_hero_frame_matches_reference(opaque_px_cap):
    """Image PSNR >= 40 dB (the goldens bar, tests/test_goldens.py:48) --
    measured ~85 dB full-screen and ~99 dB compacted, at most one u8 step
    apart; the stats dict equal key for key (same integers, same per-layer
    vectors)."""
    scene, model, uniforms, env, config = headline_host(256, 128, host=REF_HOST)
    config = dataclasses.replace(config, opaque_px_cap=opaque_px_cap, p_cap=1 << 13)
    sim = Similarity(rotation=quat_from_axis_angle([0, 1, 0], 0.3))
    img_r, stats_r = ref_frame.render_frame_stats(
        scene.device_arrays(), ref_build(scene, [(model, sim)], uniforms),
        _ref_config(config), env,
    )
    dev_p, state_p, env_p = _port_frame_inputs(256, 128, 0.3)
    img_p, stats_p = port_frame.render_frame_stats(dev_p, state_p, config, env_p)
    img_r = np.asarray(img_r)
    assert img_p.dtype == torch.uint8 and tuple(img_p.shape) == img_r.shape == (1, 128, 256, 4)
    db = psnr(img_r, img_p.numpy())
    assert db >= 40.0, db
    assert np.abs(img_r.astype(int) - img_p.numpy().astype(int)).max() <= 1
    assert ref_frame.stats_to_host(stats_r) == port_frame.stats_to_host(stats_p)
    assert port_frame.stats_to_host(stats_p)["opaque_px_needed"] > 0


def test_hero_golden_is_the_reference_frame():
    """tests/goldens/torch_hero_256x128.npz holds the reference's hero frame
    at 256x128 (helmet at 0.3 rad, the headline config, raster="pallas"):
    the image chip_smoke.py holds the card's frame against, where jax is not
    imported. The reference must still render it (PSNR >= 40 dB, the
    goldens bar), and so must the port on the CPU. Regenerate with
    SC_REGEN_GOLDENS=1."""
    scene, model, uniforms, env, config = headline_host(256, 128, host=REF_HOST)
    sim = Similarity(rotation=quat_from_axis_angle([0, 1, 0], 0.3))
    img_r = np.asarray(ref_frame.render_frame(
        scene.device_arrays(), ref_build(scene, [(model, sim)], uniforms),
        _ref_config(config), env,
    ))
    if os.environ.get("SC_REGEN_GOLDENS"):
        np.savez_compressed(HERO_GOLDEN, image=img_r)
    golden = np.load(HERO_GOLDEN)["image"]
    assert golden.shape == (1, 128, 256, 4) and golden.dtype == np.uint8
    assert psnr(golden, img_r) >= 40.0
    dev_p, state_p, env_p = _port_frame_inputs(256, 128, 0.3)
    img_p = port_frame.render_frame(dev_p, state_p, config, env_p)
    assert psnr(golden, img_p.numpy()) >= 40.0


def test_render_config_matches_reference():
    ref = {f.name: f.default for f in dataclasses.fields(ref_frame.RenderConfig)}
    port = {f.name: f.default for f in dataclasses.fields(RenderConfig)}
    assert list(ref) == list(port)
    assert ref == port
    assert port_frame.DEFAULT_OPAQUE_PX_CAP == ref_frame.DEFAULT_OPAQUE_PX_CAP
    assert port_frame.DEFAULT_SKY_PX_CAP == ref_frame.DEFAULT_SKY_PX_CAP
    for need in (0, 1, 511, 512, 4000, 598656, 1 << 20, 123457):
        assert port_frame.size_worklist_cap(need) == ref_frame.size_worklist_cap(need)
    assert RenderConfig(raster="auto").resolve_raster() == "pallas"
    assert RenderConfig(raster="pallas").resolve_raster() == "pallas"
    assert RenderConfig(raster="ref").resolve_raster() == "ref"
    with pytest.raises(ValueError):
        RenderConfig(raster="other").resolve_raster()


def _hero_frames(matq3x3=False, **change):
    """The 256x128 hero at 0.3 rad through the reference (in process,
    raster="pallas") and the port with the same config change and
    Scene.matq3x3 on both sides -> (ref image, ref stats, port image,
    port stats, port tables)."""
    scene, model, uniforms, env, config = headline_host(256, 128, host=REF_HOST)
    config = dataclasses.replace(config, p_cap=1 << 13, **change)
    scene.matq3x3 = matq3x3
    sim = Similarity(rotation=quat_from_axis_angle([0, 1, 0], 0.3))
    img_r, stats_r = ref_frame.render_frame_stats(
        scene.device_arrays(), ref_build(scene, [(model, sim)], uniforms),
        _ref_config(config), env,
    )
    p_scene, p_model, p_uniforms, p_env, _ = headline_host(256, 128)
    p_scene.matq3x3 = matq3x3
    dev_p = scene_to_torch(p_scene, "cpu")
    p_sim = port_math3d.Similarity(rotation=port_math3d.quat_from_axis_angle([0, 1, 0], 0.3))
    state_p = port_build(p_scene, [(p_model, p_sim)], p_uniforms, device="cpu")
    img_p, stats_p = port_frame.render_frame_stats(dev_p, state_p, config, p_env)
    return (np.asarray(img_r), ref_frame.stats_to_host(stats_r), img_p.numpy(),
            port_frame.stats_to_host(stats_p), dev_p)


@pytest.mark.parametrize("change", [dict(shade_row_pad=128)])
def test_outside_the_slice_raises(change):
    """shade_row_pad (the reference's TPU lane padding of the shade row,
    sliced off after each gather): the padded port frame equals the pad-0
    frame byte for byte, and is >= 40 dB from the reference's padded frame
    with an equal stats dict."""
    img_r, stats_r, img_p, stats_p, _ = _hero_frames(**change)
    _, _, img_0, stats_0, _ = _hero_frames()
    assert np.array_equal(img_p, img_0) and stats_p == stats_0
    assert psnr(img_r, img_p) >= 40.0
    assert stats_p == stats_r and stats_p["opaque_px_needed"] > 0


def test_hero_frame_with_mq3_rows_matches_reference():
    """Scene.matq3x3: the hero's material pool as wide (N, 208) mq3 rows
    on both sides; the frame is >= 40 dB from the reference's with an
    equal stats dict, and from the port's 64 B-row frame."""
    img_r, stats_r, img_p, stats_p, dev_p = _hero_frames(matq3x3=True)
    assert dev_p["texels_mq"].shape[-1] == 208 and "texels_mq_tail" not in dev_p
    assert psnr(img_r, img_p) >= 40.0
    assert stats_p == stats_r
    _, _, img_64, stats_64, dev_64 = _hero_frames()
    assert dev_64["texels_mq"].shape[-1] == 64
    assert psnr(img_64, img_p) >= 40.0 and stats_64 == stats_p


def _stats(**kw):
    base = {
        "pairs_needed": 0, "layers_needed": 0, "clip_layers_needed": 0,
        "blend_layers_needed": 0, "particle_layers_needed": 0,
        "shade_px_needed": 0, "shade_px_needed_k": [0, 0, 0, 0],
        "opaque_px_needed": 0, "sky_px_needed": 0, "matq_classic_needed": 0,
        "clip_px_needed_k": [0, 0, 0, 0],
    }
    base.update(kw)
    return base


SEQUENCES = {
    "grow_then_tighten": [
        _stats(pairs_needed=300000, opaque_px_needed=700000, sky_px_needed=1400000),
        _stats(pairs_needed=300000, opaque_px_needed=700000, sky_px_needed=1400000),
        _stats(pairs_needed=300000, opaque_px_needed=700000, sky_px_needed=1400000),
    ],
    "sky_engages": [
        _stats(pairs_needed=9000, opaque_px_needed=1500000, sky_px_needed=600000),
        _stats(pairs_needed=9000, opaque_px_needed=1500000, sky_px_needed=600000),
        _stats(pairs_needed=9000, opaque_px_needed=1500000, sky_px_needed=700000),
        _stats(pairs_needed=9000, opaque_px_needed=1500000, sky_px_needed=700000),
    ],
    # clip + blend: p_cap grows then tightens, the shared and per-layer
    # transparent worklists size themselves, then each pass's K is pinned
    "clip_blend_tighten": [
        _stats(pairs_needed=900000, layers_needed=3, clip_layers_needed=3,
               blend_layers_needed=1, shade_px_needed=200000,
               shade_px_needed_k=[150000, 0, 0, 0], opaque_px_needed=700000,
               sky_px_needed=1400000, clip_px_needed_k=[200000, 180000, 5000, 0]),
        _stats(pairs_needed=900000, layers_needed=3, clip_layers_needed=3,
               blend_layers_needed=1, shade_px_needed=200000,
               shade_px_needed_k=[150000, 0, 0, 0], opaque_px_needed=700000,
               sky_px_needed=1400000, clip_px_needed_k=[200000, 180000, 5000, 0]),
        _stats(pairs_needed=900000, layers_needed=3, clip_layers_needed=3,
               blend_layers_needed=1, shade_px_needed=200000,
               shade_px_needed_k=[150000, 0, 0, 0], opaque_px_needed=700000,
               sky_px_needed=1400000, clip_px_needed_k=[200000, 180000, 5000, 0]),
        _stats(pairs_needed=900000, layers_needed=3, clip_layers_needed=3,
               blend_layers_needed=1, shade_px_needed=200000,
               shade_px_needed_k=[150000], opaque_px_needed=700000,
               sky_px_needed=1400000, clip_px_needed_k=[200000, 180000, 5000, 0]),
    ],
    # blend deeper than K grows blend_layers; a deep layer's worklist then
    # overflows its per-layer cap and grows it alone
    "blend_overflow": [
        _stats(pairs_needed=50000, layers_needed=6, clip_layers_needed=2,
               blend_layers_needed=6, shade_px_needed=90000,
               shade_px_needed_k=[90000, 60000, 4000, 1000],
               opaque_px_needed=400000, sky_px_needed=1700000,
               clip_px_needed_k=[30000, 2000, 0, 0]),
        _stats(pairs_needed=50000, layers_needed=6, clip_layers_needed=2,
               blend_layers_needed=6, shade_px_needed=90000,
               shade_px_needed_k=[90000, 60000, 4000, 1000, 800, 300, 0, 0],
               opaque_px_needed=400000, sky_px_needed=1700000,
               clip_px_needed_k=[30000, 2000, 0, 0, 0, 0, 0, 0]),
        _stats(pairs_needed=50000, layers_needed=6, clip_layers_needed=2,
               blend_layers_needed=6, shade_px_needed=0,
               shade_px_needed_k=[90000, 60000, 40000, 1000, 800, 300, 0, 0],
               opaque_px_needed=400000, sky_px_needed=1700000,
               clip_px_needed_k=[30000, 2000]),
        _stats(pairs_needed=50000, layers_needed=6, clip_layers_needed=2,
               blend_layers_needed=6, shade_px_needed=0,
               shade_px_needed_k=[90000, 60000, 40000, 1000, 800, 300, 0, 0],
               opaque_px_needed=400000, sky_px_needed=1700000,
               clip_px_needed_k=[30000, 2000]),
    ],
}
# all passes on a partial interleaved pool: the clip depth grows past 8,
# the partition engages at a need of 0 and then grows, the particle depth
# is pinned to its need and the per-layer worklists sized; once geometry
# covers more than half the screen the sky worklist engages
_AP = dict(pairs_needed=127366, layers_needed=9, clip_layers_needed=9,
           blend_layers_needed=2, particle_layers_needed=3, shade_px_needed=496768,
           shade_px_needed_k=[496768, 257024, 43008, 0], opaque_px_needed=1134080,
           sky_px_needed=1146240, matq_classic_needed=0,
           clip_px_needed_k=[320384, 320384, 1920, 256])
SEQUENCES["all_passes"] = [_stats(**_AP)] + [
    _stats(**{**_AP, "matq_classic_needed": 210000, "sky_px_needed": 900000})
] * 5
# particles deeper than K grow particle_layers alone; blend tightens once
# clip and particles no longer inherit it
SEQUENCES["particle_overflow"] = [
    _stats(pairs_needed=60000, layers_needed=6, clip_layers_needed=2,
           blend_layers_needed=1, particle_layers_needed=6, shade_px_needed=80000,
           shade_px_needed_k=[80000, 30000, 9000, 2000], opaque_px_needed=900000,
           sky_px_needed=1300000, clip_px_needed_k=[40000, 1000, 0, 0]),
] * 2 + [
    _stats(pairs_needed=60000, layers_needed=6, clip_layers_needed=2,
           blend_layers_needed=1, particle_layers_needed=6, shade_px_needed=80000,
           shade_px_needed_k=[80000, 30000, 9000, 2000, 700, 300, 0, 0],
           opaque_px_needed=900000, sky_px_needed=1300000,
           clip_px_needed_k=[40000, 1000, 0, 0]),
] * 3
TRANSPARENT = ("clip_blend_tighten", "blend_overflow", "all_passes", "particle_overflow")
WITH_PARTICLES = ("all_passes", "particle_overflow")
PARTIAL_POOL = ("all_passes",)


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_fit_caps_matches_bench(monkeypatch, seq):
    """The same stats frames drive bench.fit_caps and the port's fit_caps
    to the same capacities, round by round."""
    frames = SEQUENCES[seq]
    seen = {"ref": 0, "port": 0}

    def fake(key):
        def stats_frame(dev, state, config, env):
            i = min(seen[key], len(frames) - 1)
            seen[key] += 1
            return None, dict(frames[i])

        return stats_frame

    monkeypatch.setattr(ref_frame, "render_frame_stats", fake("ref"))
    monkeypatch.setattr(ref_frame, "stats_to_host", lambda s: s)
    monkeypatch.setattr(port_caps, "render_frame_stats", fake("port"))
    monkeypatch.setattr(port_caps, "stats_to_host", lambda s: s)
    transparent = seq in TRANSPARENT
    particles = seq in WITH_PARTICLES
    config = RenderConfig(width=1920, height=1080, t_cap=1 << 15,
                          t_cap_anim=1 << 6, p_cap=1 << 17,
                          enable_clip=transparent, enable_blend=transparent,
                          enable_lines=particles, enable_particles=particles)
    # the growers read only whether the scene publishes a partial pool
    dev = {"matq_capable": None} if seq in PARTIAL_POOL else {}
    ref = bench.fit_caps(dev, None, _ref_config(config), None)
    port = port_caps.fit_caps(dev, None, config, None)
    for f in ("p_cap", "opaque_px_cap", "sky_px_cap", "clip_layers", "blend_layers",
              "particle_layers", "shade_px_cap", "shade_px_caps", "clip_px_caps",
              "matq_classic_cap"):
        assert getattr(ref, f) == getattr(port, f), f
    assert seen["ref"] == seen["port"]
    if transparent:
        assert port.shade_px_caps is not None and port.clip_layers is not None
    if particles:
        assert port.particle_layers is not None
    if seq == "all_passes":
        assert port.matq_classic_cap > 512 and port.sky_px_cap and port.clip_layers == 16


def _golden_scene(name, box_glb):
    """The port's (scene tables, FrameState, config, env) of the
    reference's PNG golden `name` (tests/test_goldens.py:51-87), with the
    goldens' own raster="ref"."""
    from superconductor_tpu_torch.assets.models import load_model
    from superconductor_tpu_torch.render.camera import Camera, make_uniforms
    from superconductor_tpu_torch.render.env import EnvBindings
    from superconductor_tpu_torch.scene.scene import Scene
    from superconductor_tpu_torch.utils.procgen import add_pbr_sphere, default_ambient_sh

    m3 = port_math3d
    scene = Scene()
    if name == "unlit_box":
        model = load_model(scene, box_glb, name="box")
        camera = Camera(position=np.array([0.9, 0.8, 1.8], np.float32))
        camera.rotation = m3.mat3_to_quat(m3.mat4_inverse(m3.look_at(camera.position, [0, 0, 0]))[:3, :3])
        uniforms, angle = make_uniforms(camera, 128, 128), 0.4
        config = RenderConfig(width=128, height=128, t_cap=32, t_cap_anim=8, raster="ref")
        env = EnvBindings(clear_color=(0.1, 0.15, 0.3))
    else:
        model = add_pbr_sphere(scene, stacks=32, slices=32)
        camera = Camera(position=np.array([0.0, 0.25, 2.3], np.float32))
        uniforms, angle = make_uniforms(camera, 160, 120), 0.6
        config = RenderConfig(width=160, height=120, t_cap=4096, t_cap_anim=8, raster="ref")
        env = EnvBindings(ambient_sh=default_ambient_sh(), clear_color=(0.1, 0.12, 0.25))
    sim = m3.Similarity(rotation=m3.quat_from_axis_angle([0, 1, 0], angle))
    state = port_build(scene, [(model, sim)], uniforms, device="cpu")
    return scene_to_torch(scene, "cpu"), state, config, env


@pytest.mark.parametrize("name", ["unlit_box", "pbr_sphere"])
def test_reference_png_golden_through_the_port(name, box_glb):
    """tests/goldens/unlit_box.png and pbr_sphere.png, the reference's own
    goldens, rendered by the port on the CPU with their raster="ref":
    PSNR >= 40 dB, the goldens' bar (tests/test_goldens.py:48)."""
    import imageio.v3 as iio

    dev, state, config, env = _golden_scene(name, box_glb)
    img = port_frame.render_frame(dev, state, config, env)[0].numpy()
    golden = iio.imread(os.path.join(REPO, "tests", "goldens", f"{name}.png"))
    assert golden.shape == img.shape
    db = psnr(golden, img)
    assert db >= 40.0, db


@pytest.mark.parametrize("block_jax", [True, False])
def test_port_renders_without_jax(tmp_path, box_glb, block_jax):
    """A child process imports the port, loads a box GLB written here,
    renders a small frame on the CPU, and never loads jax: with jax
    blocked outright, and with jax importable but unused (the GPU
    machine's situation)."""
    glb = tmp_path / "box.glb"
    glb.write_bytes(box_glb)
    script = textwrap.dedent(
        f"""
        import sys
        if {block_jax!r}:
            sys.modules["jax"] = None
        sys.path.insert(0, {REPO!r})
        import numpy as np
        from superconductor_tpu_torch import math3d as m
        from superconductor_tpu_torch.assets.models import load_model
        from superconductor_tpu_torch.render.camera import Camera, make_uniforms
        from superconductor_tpu_torch.render.draws import build_frame_state
        from superconductor_tpu_torch.render.env import EnvBindings
        from superconductor_tpu_torch.render.frame import RenderConfig, render_frame_stats, stats_to_host
        from superconductor_tpu_torch.scene.scene import Scene
        from superconductor_tpu_torch.scene.upload import scene_to_torch
        from superconductor_tpu_torch.utils.procgen import default_ambient_sh

        scene = Scene()
        model = load_model(scene, open({str(glb)!r}, "rb").read(), name="box")
        cam = Camera(position=np.array([0.9, 0.8, 1.8], np.float32))
        cam.rotation = m.mat3_to_quat(m.mat4_inverse(m.look_at(cam.position, [0, 0, 0]))[:3, :3])
        uniforms = make_uniforms(cam, 128, 64)
        env = EnvBindings(clear_color=(0.0, 0.0, 1.0), ambient_sh=default_ambient_sh())
        state = build_frame_state(scene, [(model, m.Similarity())], uniforms, device="cpu")
        img, stats = render_frame_stats(scene_to_torch(scene, "cpu"), state,
                                        RenderConfig(width=128, height=64, t_cap=64, t_cap_anim=8), env)
        stats = stats_to_host(stats)
        assert tuple(img.shape) == (1, 64, 128, 4), img.shape
        rgb = img[0, :, :, :3]
        covered = (rgb != rgb[0, 0]).any(dim=-1).float().mean().item()
        assert 0.05 < covered < 0.95, covered
        assert stats["opaque_px_needed"] > 0
        assert sys.modules.get("jax") is None, "jax was loaded"
        assert "superconductor_tpu" not in sys.modules, "the reference was loaded"
        print("OK", covered)
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=120, cwd=str(tmp_path), env=env,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("OK")

"""Views and bands: stereo frames through the port against the reference.

Held against the reference, rendered in ONE child process whose XLA CPU
backend is capped at AVX (without FMA contraction the reference's setup
rows and rasters round op by op, as the port's do; tests/test_torch_raster.py):

* the stereo box of tests/test_stereo.py:21 (96x96, ipd 0.3, the per-eye
  culling union, raster="ref"), with its parallax;
* the stereo-animated scene (scenes.stereo_animated_host, bench.py:887) cut
  to two tubes of 8 x 6 and two spheres at 128x64, two views in two bands,
  its palettes from the native FK and, in a second frame, the numpy one,
  each on both sides;
* two views of the small all-passes scene with lines and particles on;
* the 256x128 stereo-animated frame stored in tests/goldens, which
  chip_smoke.py holds the card's frame against.

Each frame: PSNR >= 40 dB (the goldens bar, tests/test_goldens.py:48) and
the stats dict equal key for key. The port's frames are also rendered in
2 and 4 bands, byte for byte equal to one band. The stereo helpers are bit
for bit; the blits within 1e-6 (see test_blit_matches_reference)."""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

import superconductor_tpu.render.stereo as ref_stereo
from conftest import make_box_glb
from superconductor_tpu.ops import blit as ref_blit
from superconductor_tpu.utils.metrics import psnr
from superconductor_tpu_torch.assets.models import load_model
from superconductor_tpu_torch.ops import blit as port_blit
from superconductor_tpu_torch.ops import shade as port_shade
from superconductor_tpu_torch.ops import tonemap as port_tonemap
from superconductor_tpu_torch.render import frame as port_frame
from superconductor_tpu_torch.render import stereo as port_stereo
from superconductor_tpu_torch.render.camera import Camera
from superconductor_tpu_torch.render.caps import fit_caps
from superconductor_tpu_torch.render.culling import sphere_culling_params
from superconductor_tpu_torch.render.draws import build_frame_state
from superconductor_tpu_torch.render.env import EnvBindings
from superconductor_tpu_torch.render.frame import RenderConfig
from superconductor_tpu_torch.scene.upload import scene_to_torch
from superconductor_tpu_torch.scenes import (
    HOST,
    STEREO_SMALL,
    STEREO_TINY,
    _aim,
    all_passes_host,
    stereo_animated_host,
)
from superconductor_tpu_torch import math3d
from test_torch_host import JOINT_PATHS, REF_HOST, assert_same, joint_path

# The test workers share the CPU: torch's default of a thread per core in
# each of them oversubscribes it many times over.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "torch_stereo_256x128.npz")
REGEN = bool(os.environ.get("SC_REGEN_GOLDENS"))
T_TINY = 0.5  # the small stereo-animated frame's time
T_GOLDEN = 0.0  # the golden's: the state fit_caps sizes the caps on, as in bench.py
# the capacities the port's fit_caps gives each frame (test_fit_caps_gives_the_stored_caps)
CAPS = {
    "tiny": {"p_cap": 512, "opaque_px_cap": 131072, "row_chunks": 2},
    "lines": {"p_cap": 18432, "opaque_px_cap": 131072, "clip_layers": 2, "blend_layers": 1,
              "particle_layers": 4, "shade_px_caps": (6144, 3840, 2304, 512),
              "matq_classic_cap": 2176},
}


def _ap_stereo_host(host, stereo):
    """The all-passes scene at 128x64 (spheres of 16 stacks, LODs for a
    64-px screen) seen by two eyes 0.4 apart around its camera, through
    `stereo`'s stereo_uniforms_from_camera -> (scene, instances, uniforms,
    env, config with two views, draw keywords)."""
    scene, instances, _uniforms, env, config, draw_kw = all_passes_host(
        128, 64, stacks=16, lod_screen_height=64, host=host)
    cam = host.Camera(position=np.array([8.0, 2.5, 3.0], np.float32))
    _aim(cam, [0, 1.2, 0], host.math3d)
    uniforms = stereo.stereo_uniforms_from_camera(cam, 128, 64, ipd=0.4)
    return scene, instances, uniforms, env, dataclasses.replace(config, num_views=2), draw_kw


def _box_host(host, stereo, load):
    """tests/test_stereo.py:21's stereo box -> (scene, instances,
    uniforms, culling params of both eyes, config)."""
    scene = host.Scene()
    model = load(scene, make_box_glb(), name="box")
    uniforms = stereo.stereo_uniforms_from_camera(
        host.Camera(position=np.array([0, 0, 1.6], np.float32)), 96, 96, ipd=0.3)
    config = RenderConfig(width=96, height=96, t_cap=64, t_cap_anim=8, raster="ref", num_views=2)
    return scene, [(model, host.math3d.Similarity())], uniforms, config


def _golden_caps() -> dict:
    if REGEN:
        return _fit("golden")[1]
    caps = json.loads(str(np.load(GOLDEN)["caps"]))
    return {k: tuple(v) if isinstance(v, list) else v for k, v in caps.items()}


_REFERENCE_CHILD = textwrap.dedent(
    """
    import dataclasses, json, sys
    import numpy as np
    sys.path.insert(0, "tests")
    import superconductor_tpu.render.stereo as ref_stereo
    from superconductor_tpu.assets.models import load_model
    from superconductor_tpu.render import frame as ref_frame
    from superconductor_tpu.render.culling import sphere_culling_params
    from superconductor_tpu.render.draws import build_frame_state
    from superconductor_tpu_torch.scenes import STEREO_SMALL, STEREO_TINY, stereo_animated_host
    import test_torch_stereo as T
    from test_torch_host import REF_HOST, joint_path

    caps = json.loads(sys.argv[2])
    out = {}

    def render(name, scene, state, config, env):
        cfg = {**dataclasses.asdict(config), **caps.get(name, {})}
        cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}
        if cfg["raster"] == "auto":
            cfg["raster"] = "pallas"
        img, stats = ref_frame.render_frame_stats(
            scene.device_arrays(), state, ref_frame.RenderConfig(**cfg), env)
        out[name + "/image"] = np.asarray(img)
        out[name + "/stats"] = json.dumps(ref_frame.stats_to_host(stats))

    scene, instances, uniforms, config = T._box_host(REF_HOST, ref_stereo, load_model)
    culls = [sphere_culling_params(uniforms.view_proj[v]) for v in range(2)]
    state = build_frame_state(scene, instances, uniforms, cull_params=culls)
    render("box", scene, state, config, ref_frame.EnvBindings())

    for name, kw, t, mode in (("tiny", STEREO_TINY, T.T_TINY, "native"),
                              ("tiny-numpy", STEREO_TINY, T.T_TINY, "numpy"),
                              ("golden", STEREO_SMALL, T.T_GOLDEN, "native")):
        scene, frame_inputs, uniforms, env, config = stereo_animated_host(**kw, host=REF_HOST)
        with joint_path(mode):
            instances, palettes = frame_inputs(t)
            state = build_frame_state(scene, instances, uniforms, joint_palettes=palettes)
        render(name, scene, state, config, env)

    scene, instances, uniforms, env, config, draw_kw = T._ap_stereo_host(REF_HOST, ref_stereo)
    state = build_frame_state(scene, instances(0.3), uniforms, **draw_kw)
    render("lines", scene, state, config, env)
    np.savez(sys.argv[1], **out)
    """
)


@pytest.fixture(scope="module", autouse=True)
def _reference_child():
    """Starts the reference's four frames in the AVX-capped child with the
    module's first test; `reference(name)` waits for it."""
    caps = {**CAPS, "golden": _golden_caps()}
    caps["tiny-numpy"] = caps["tiny"]
    with tempfile.TemporaryDirectory() as tmp:
        dst = os.path.join(tmp, "reference.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
        env.pop("PYTHONPATH", None)
        proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE_CHILD, dst, json.dumps(caps)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )

        @functools.lru_cache(maxsize=None)
        def result():
            out, _ = proc.communicate(timeout=900)
            assert proc.returncode == 0, out
            return dict(np.load(dst))

        try:
            yield result
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.communicate()


@pytest.fixture
def reference(_reference_child):
    def get(name):
        ref = _reference_child()
        return ref[name + "/image"], json.loads(str(ref[name + "/stats"]))

    return get


# --- the port's frames ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _inputs(name):
    """(tables, FrameState, config before fitting, env) of a frame of the
    port on the CPU."""
    if name == "box":
        scene, instances, uniforms, config = _box_host(HOST, port_stereo, load_model)
        culls = [sphere_culling_params(uniforms.view_proj[v]) for v in range(2)]
        state = build_frame_state(scene, instances, uniforms, cull_params=culls, device="cpu")
        return scene_to_torch(scene, "cpu"), state, config, EnvBindings()
    if name == "lines":
        scene, instances, uniforms, env, config, draw_kw = _ap_stereo_host(HOST, port_stereo)
        state = build_frame_state(scene, instances(0.3), uniforms, device="cpu", **draw_kw)
        return scene_to_torch(scene, "cpu"), state, config, env
    tiny = name.startswith("tiny")
    kw, t = (STEREO_TINY, T_TINY) if tiny else (STEREO_SMALL, T_GOLDEN)
    scene, frame_inputs, uniforms, env, config = stereo_animated_host(**kw)
    with joint_path("numpy" if name.endswith("-numpy") else "native"):
        instances, palettes = frame_inputs(t)
    state = build_frame_state(scene, instances, uniforms, joint_palettes=palettes, device="cpu")
    if tiny:
        config = dataclasses.replace(config, row_chunks=2)
    return scene_to_torch(scene, "cpu"), state, config, env


@functools.lru_cache(maxsize=None)
def _fit(name):
    """The port's fit_caps -> (config, the fields it changed)."""
    dev, state, config, env = _inputs(name)
    fitted = fit_caps(dev, state, config, env)
    return fitted, {f.name: getattr(fitted, f.name) for f in dataclasses.fields(fitted)
                    if getattr(fitted, f.name) != getattr(config, f.name)}


def _config(name, **kw):
    dev, state, config, env = _inputs(name)
    caps = {**CAPS, "golden": _golden_caps()}.get(name.replace("-numpy", ""), {})
    return dataclasses.replace(config, **{**caps, **kw})


@functools.lru_cache(maxsize=None)
def _port_frame(name, **kw):
    dev, state, _config_, env = _inputs(name)
    img, stats = port_frame.render_frame_stats(dev, state, _config(name, **kw), env)
    return img, port_frame.stats_to_host(stats)


def _assert_matches(reference, name):
    img_r, stats_r = reference(name)
    img_p, stats_p = _port_frame(name)
    assert img_p.dtype == torch.uint8 and tuple(img_p.shape) == img_r.shape
    db = psnr(img_r, img_p.numpy())
    assert db >= 40.0, db
    assert stats_p == stats_r
    return img_p.numpy(), stats_p


# --- stereo helpers and blits --------------------------------------------

@pytest.mark.parametrize("reverse_z", [True, False])
def test_stereo_helpers_match_reference(reverse_z):
    """stereo_uniforms_from_camera on seeded cameras and eye distances, and
    composite_side_by_side, bit for bit."""
    rng = np.random.default_rng(41)
    for _ in range(4):
        pos = rng.uniform(-3, 3, size=3).astype(np.float32)
        q = math3d.quat_normalize(rng.normal(size=4).astype(np.float32))
        w, h = int(rng.integers(16, 2000)), int(rng.integers(16, 1200))
        kw = dict(ipd=float(rng.uniform(0.01, 0.5)), fov_y=float(rng.uniform(0.5, 1.5)),
                  z_near=float(rng.uniform(0.01, 0.5)), reverse_z=reverse_z)
        ur = ref_stereo.stereo_uniforms_from_camera(REF_HOST.Camera(pos, q), w, h, **kw)
        up = port_stereo.stereo_uniforms_from_camera(Camera(pos, q), w, h, **kw)
        assert_same(ur, up)
    frames = rng.integers(0, 256, size=(2, 5, 7, 4), dtype=np.uint8)
    assert_same(ref_stereo.composite_side_by_side(frames),
                port_stereo.composite_side_by_side(torch.from_numpy(frames)))


@pytest.mark.parametrize("shape", [(37, 53, 16, 20), (16, 20, 37, 53), (64, 64, 64, 32),
                                   (33, 17, 48, 5), (7, 9, 1, 1)])
def test_blit_matches_reference(shape):
    """blit and srgb_blit, down- and upsampling, within 1e-6: the port
    builds jax.image.resize's antialiased triangle weights and contracts
    with them in another summation order (measured: at most 1.8e-7, 1.5
    ulp of 1.0, on values in [0, 1])."""
    h, w, oh, ow = shape
    img = np.random.default_rng(h * w).random((h, w, 4), dtype=np.float32)
    for name in ("blit", "srgb_blit"):
        ref = np.asarray(getattr(ref_blit, name)(img, oh, ow))
        port = getattr(port_blit, name)(torch.from_numpy(img), oh, ow).numpy()
        assert port.shape == ref.shape == (oh, ow, 4) and port.dtype == ref.dtype
        np.testing.assert_allclose(port, ref, rtol=0, atol=1e-6)


def test_generate_mips_matches_reference():
    """Every level of the chain, down to 1x1 and at the level cap, within
    1e-6 as the blits."""
    img = np.random.default_rng(5).random((40, 24, 3), dtype=np.float32)
    for max_levels in (16, 3):
        ref = ref_blit.generate_mips(img, max_levels=max_levels)
        port = port_blit.generate_mips(torch.from_numpy(img), max_levels=max_levels)
        assert [np.asarray(r).shape for r in ref] == [tuple(p.shape) for p in port]
        for r, p in zip(ref, port):
            np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=0, atol=1e-6)


# --- capacities and bands ------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "lines"])
def test_fit_caps_gives_the_stored_caps(name):
    """The capacities the frames below are rendered with, on both sides,
    are those the port's fit_caps gives; over two views and, for the small
    stereo-animated frame, two bands, it reads stats maxed over both."""
    assert _fit(name)[1] == {k: v for k, v in CAPS[name].items() if k != "row_chunks"}


@pytest.mark.parametrize("chunks", [2, 4])
@pytest.mark.parametrize("name", ["tiny", "lines"])
def test_bands_equal_one_band(name, chunks):
    """The frame in `chunks` bands equals it in one, byte for byte. Of the
    stats, the per-pixel maxima (layer counts) are the same; the pixel and
    pair counts are each band's own, so no larger than one band's."""
    whole, stats_w = _port_frame(name, row_chunks=1)
    banded, stats_b = _port_frame(name, row_chunks=chunks)
    assert torch.equal(whole, banded)
    for key, value in stats_w.items():
        if key.endswith("layers_needed"):
            assert stats_b[key] == value, key
        else:
            assert np.all(np.asarray(stats_b[key]) <= np.asarray(value)), key
    assert 0 < stats_b["opaque_px_needed"] < stats_w["opaque_px_needed"]


# --- against the reference ----------------------------------------------

def test_stereo_box_matches_reference(reference):
    """tests/test_stereo.py's assertions through the port -- two views,
    each with over 100 red box pixels, the box shifted more than 4 px
    between the eyes, the side-by-side composite -- and the frame against
    the reference's."""
    img, stats = _assert_matches(reference, "box")
    assert img.shape == (2, 96, 96, 4)
    left_red, right_red = img[0][..., 0] == 255, img[1][..., 0] == 255
    assert left_red.sum() > 100 and right_red.sum() > 100
    lx = np.where(left_red.any(axis=0))[0].mean()
    rx = np.where(right_red.any(axis=0))[0].mean()
    assert lx - rx > 4
    sbs = port_stereo.composite_side_by_side(_port_frame("box")[0])
    assert sbs.shape == (96, 192, 4)
    assert np.array_equal(sbs, ref_stereo.composite_side_by_side(img))
    assert stats["pairs_needed"] == 0 and stats["opaque_px_needed"] > 0


@pytest.mark.parametrize("mode", JOINT_PATHS)
def test_stereo_animated_frame_matches_reference(reference, mode):
    """Two tubes of 8 x 6 (skinned, palettes from one FK path on both
    sides: the native walk, each package's default, or the numpy one) and
    two spheres at 128x64, two views of two bands each: stats maxed over
    the four (view, band) renders equal the reference's."""
    img, stats = _assert_matches(reference, "tiny" if mode == "native" else "tiny-numpy")
    assert img.shape == (2, 64, 128, 4)
    assert stats["pairs_needed"] > 0 and not np.array_equal(img[0], img[1])


def test_lines_and_particles_per_view_match_reference(reference):
    """Two views of the small all-passes scene, every pass on: lines and
    particles go through each view's own matrices, and each changes both
    views."""
    img, stats = _assert_matches(reference, "lines")
    assert min(stats["clip_layers_needed"], stats["blend_layers_needed"],
               stats["particle_layers_needed"]) >= 1
    dev, state, _config_, env = _inputs("lines")
    for flag in ("enable_lines", "enable_particles"):
        off = port_frame.render_frame(dev, state, _config("lines", **{flag: False}), env).numpy()
        for v in range(2):
            assert (off[v] != img[v]).any(), (flag, v)


def test_stereo_golden_is_the_reference_frame(reference):
    """tests/goldens/torch_stereo_256x128.npz holds the reference's
    stereo-animated frame at 256x128 (all six tubes, spheres of 32 stacks,
    t = 0) and the capacities it was rendered with, those the port's
    fit_caps gives. chip_smoke.py holds the card's frame against it, where
    jax is not imported. Regenerate with SC_REGEN_GOLDENS=1."""
    img_r, _stats = reference("golden")
    if REGEN:
        np.savez_compressed(GOLDEN, image=img_r, caps=json.dumps(_golden_caps()))
    golden = np.load(GOLDEN)
    assert golden["image"].shape == (2, 128, 256, 4) and golden["image"].dtype == np.uint8
    assert psnr(golden["image"], img_r) >= 40.0
    assert _fit("golden")[1] == _golden_caps()
    _assert_matches(reference, "golden")


def test_gbuffer_sum_order_and_encode_ulp_bound_the_card_cpu_gap(monkeypatch):
    """The card's 256x128 stereo frame is 96.30 dB from the CPU's, stats
    equal. chip_smoke.py (trace_gbuffer_lanes) traces interpolate_gbuffer's
    intermediates from the card frame's inputs on both devices: with
    torch.sum for its three-term sums, 12 of them differ (the first d_dx,
    776 of 25,561 live lanes, 2.4e-7): the card's reduction adds in another
    order than (a + b) + c, the CPU's (torch's and XLA's). ops/shade.py
    _sum3 writes that order out, and the card's lanes equal the CPU's; the
    frame stays 96.30 dB apart, from the sky and the encode, whose pow
    rounds an ulp apart on the card (test_torch_clip_blend.py
    test_one_ulp_in_the_encode_is_the_card_cpu_gap). Shown on the CPU:
    torch.sum gives the fixed order's g-buffer and frame bit for bit; the
    sums as a + (b + c) move g-buffer lanes by ulps and the frame by at
    most one u8 step; the encode's result one ulp up moves a few u8
    values by one step. Stats equal in each."""
    dev, state, _config_, env = _inputs("golden")
    config = _config("golden")
    img, stats = _port_frame("golden")

    def render(sum3):
        gbufs = []
        real = port_frame.interpolate_gbuffer

        def rec(*args, **kw):
            out = real(*args, **kw)
            gbufs.append(out)
            return out

        with monkeypatch.context() as m:
            m.setattr(port_shade, "_sum3", sum3)
            m.setattr(port_frame, "interpolate_gbuffer", rec)
            out, st = port_frame.render_frame_stats(dev, state, config, env)
        return out, port_frame.stats_to_host(st), gbufs

    _img, _stats, fixed = render(port_shade._sum3)
    img_s, stats_s, by_sum = render(lambda x, dim: torch.sum(x, dim=dim))
    assert torch.equal(img_s, img) and stats_s == stats
    for a, b in zip(fixed, by_sum):
        for f in ("world_pos", "normal", "uv", "lm_uv", "dpdx", "dpdy", "duvdx", "duvdy"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f

    def other_order(x, dim):
        a, b, c = x.unbind(dim)
        return a + (b + c)

    img_o, stats_o, by_other = render(other_order)
    moved = sum(int((getattr(a, f)[a.valid] != getattr(b, f)[b.valid]).sum())
                for a, b in zip(fixed, by_other) for f in ("world_pos", "dpdx", "duvdx"))
    diff = np.abs(img.numpy().astype(int) - img_o.numpy().astype(int))
    assert moved > 0 and diff.max() <= 1
    assert psnr(img.numpy(), img_o.numpy()) >= 90.0 and stats_o == stats

    real = port_tonemap.linear_to_srgb_approx

    def one_ulp_up(x):
        y = real(x)
        return torch.nextafter(y, torch.full_like(y, 2.0))

    monkeypatch.setattr(port_tonemap, "linear_to_srgb_approx", one_ulp_up)
    monkeypatch.setattr(port_shade, "linear_to_srgb_approx", one_ulp_up)
    img_u, stats_u, _ = render(port_shade._sum3)
    diff = np.abs(img.numpy().astype(int) - img_u.numpy().astype(int))
    assert diff.max() == 1 and int((diff > 0).sum()) <= 16
    assert psnr(img.numpy(), img_u.numpy()) >= 90.0 and stats_u == stats

"""The all-passes frame end to end (dense_terrain.glb, the sphere ring,
22 grid lines and 16 particles, every pass on; scenes.all_passes_host):
the 256x128 frame through the port against the reference's
render_frame_stats (raster="pallas", its Pallas kernels in interpret mode)
at the capacities the port's fit_caps gives; the golden chip_smoke.py
holds the card against; and the sky worklist against the full-screen sky.
The material-path partition and the classic samplers on the scene's own
tables are held against the reference in tests/test_torch_shade.py.

The terrain's material has a 512^2 albedo chain and a 256^2 normal chain,
so it cannot take the interleaved pool: the pool is partial and fit_caps
engages the partition. The frame is scenes.ALL_PASSES_SMALL: 256x128,
spheres cut from 88 to 32 stacks, LODs chosen for a 128-px-tall screen."""

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

from superconductor_tpu.render import frame as ref_frame
from superconductor_tpu.utils.metrics import psnr
from superconductor_tpu_torch.render import frame as port_frame
from superconductor_tpu_torch.render.caps import fit_caps
from superconductor_tpu_torch.render.draws import build_frame_state as port_build
from superconductor_tpu_torch.render.env import EnvBindings
from superconductor_tpu_torch.render.camera import Camera, make_uniforms
from superconductor_tpu_torch.render.frame import RenderConfig
from superconductor_tpu_torch.scene.scene import Scene
from superconductor_tpu_torch.scene.upload import scene_to_torch
from superconductor_tpu_torch.scenes import ALL_PASSES_SMALL, all_passes_host
from superconductor_tpu_torch.utils.procgen import add_pbr_sphere, default_ambient_sh, gradient_cubemap
from superconductor_tpu_torch import math3d
from test_torch_host import REF_HOST

# The test workers share the CPU: torch's default of a thread per core in
# each of them oversubscribes it many times over.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "torch_all_passes_256x128.npz")
ANGLE = 0.3  # sphere turn of the golden frame
REGEN = bool(os.environ.get("SC_REGEN_GOLDENS"))


@functools.lru_cache(maxsize=None)
def _host():
    """The scene built by the port's host layer."""
    return all_passes_host(**ALL_PASSES_SMALL)


@functools.lru_cache(maxsize=None)
def _tables():
    return scene_to_torch(_host()[0], "cpu")


def _state():
    scene, instances, uniforms, _env, _config, draw_kw = _host()
    return port_build(scene, instances(ANGLE), uniforms, device="cpu", **draw_kw)


@functools.lru_cache(maxsize=None)
def _fitted():
    """The port's fit_caps on the small frame -> (config, grow per round)."""
    rounds = []
    config = fit_caps(_tables(), _state(), _host()[4], _host()[3],
                      log=lambda stats, grow: rounds.append(grow))
    return config, rounds


def _caps(config) -> dict:
    """The fields fitting changed from the scene's config, JSON-ready."""
    base = _host()[4]
    return {f.name: getattr(config, f.name) for f in dataclasses.fields(config)
            if getattr(config, f.name) != getattr(base, f.name)}


def _golden_caps() -> dict:
    if REGEN:
        return _caps(_fitted()[0])
    caps = json.loads(str(np.load(GOLDEN)["caps"]))
    return {k: tuple(v) if isinstance(v, list) else v for k, v in caps.items()}


_REFERENCE_CHILD = textwrap.dedent(
    """
    import dataclasses, json, sys
    import numpy as np
    from superconductor_tpu.render import frame as ref_frame
    from superconductor_tpu.render.draws import build_frame_state
    from superconductor_tpu_torch.scenes import ALL_PASSES_SMALL, all_passes_host
    sys.path.insert(0, "tests")
    from test_torch_host import REF_HOST

    caps, angle = json.loads(sys.argv[2]), float(sys.argv[3])
    caps = {k: tuple(v) if isinstance(v, list) else v for k, v in caps.items()}
    scene, instances, uniforms, env, config, draw_kw = all_passes_host(
        **ALL_PASSES_SMALL, host=REF_HOST)
    state = build_frame_state(scene, instances(angle), uniforms, **draw_kw)
    rcfg = ref_frame.RenderConfig(**{**dataclasses.asdict(config), **caps, "raster": "pallas"})
    img, stats = ref_frame.render_frame_stats(scene.device_arrays(), state, rcfg, env)
    np.savez(sys.argv[1], image=np.asarray(img), stats=json.dumps(ref_frame.stats_to_host(stats)))
    """
)


@pytest.fixture(scope="module")
def reference():
    """A callable -> (image, stats) of the reference's render_frame_stats
    at the golden's capacities, rendered in a child process whose XLA CPU
    backend is capped at AVX: with FMA instructions the jitted reference
    contracts the multiply-adds of its setup rows and a bounding box moves
    by a pixel (tests/test_torch_clip_blend.py); without them it rounds op
    by op, as the port does. The child starts here and runs while the
    tests do the port's side; the callable waits for it."""
    caps = _golden_caps()
    with tempfile.TemporaryDirectory() as tmp:
        dst = os.path.join(tmp, "reference.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
        env.pop("PYTHONPATH", None)
        proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE_CHILD, dst, json.dumps(caps), str(ANGLE)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )

        @functools.lru_cache(maxsize=None)
        def result():
            out, _ = proc.communicate(timeout=900)
            assert proc.returncode == 0, out
            ref = np.load(dst)
            return ref["image"], json.loads(str(ref["stats"]))

        try:
            yield result
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.communicate()


@functools.lru_cache(maxsize=None)
def _port_frame():
    config = dataclasses.replace(_host()[4], **_golden_caps())
    img, stats = port_frame.render_frame_stats(_tables(), _state(), config, _host()[3])
    return img.numpy(), port_frame.stats_to_host(stats)


def test_all_passes_frame_matches_reference(reference):
    """At the capacities the port's fit_caps gives (those stored with the
    golden, which the reference renders with): image PSNR >= 40 dB (the
    goldens bar, tests/test_goldens.py:48) and the stats dict equal key for
    key, with every pass engaged -- clip and blend fragments, particle
    layers, and the terrain's lanes sampled through the material-path
    partition, which fit_caps engaged along with the particle depth and
    the per-layer worklists."""
    config, rounds = _fitted()
    assert _caps(config) == _golden_caps()
    assert {"matq_classic_cap", "particle_layers", "shade_px_caps"} <= set().union(*rounds)
    img_p, stats_p = _port_frame()
    img_r, stats_r = reference()
    assert img_p.dtype == np.uint8 and img_p.shape == img_r.shape == (1, 128, 256, 4)
    db = psnr(img_r, img_p)
    assert db >= 40.0, db
    assert stats_r == stats_p
    caps = _golden_caps()
    assert caps["matq_classic_cap"] >= stats_p["matq_classic_needed"] > 0
    assert min(stats_p["clip_layers_needed"], stats_p["blend_layers_needed"],
               stats_p["particle_layers_needed"]) >= 1


def test_all_passes_golden_is_the_reference_frame(reference):
    """tests/goldens/torch_all_passes_256x128.npz holds the reference's
    all-passes frame at 256x128 (spheres at 0.3 rad, raster="pallas") and
    the capacities it was rendered with -- those the port's fit_caps gives
    the same frame. chip_smoke.py holds the card's frame against it, where
    jax is not imported. The reference must still render it (PSNR >= 40
    dB) and so must the port. Regenerate with SC_REGEN_GOLDENS=1."""
    img_r = reference()[0]
    if REGEN:
        np.savez_compressed(GOLDEN, image=img_r, caps=json.dumps(_golden_caps()))
    golden = np.load(GOLDEN)
    assert golden["image"].shape == (1, 128, 256, 4) and golden["image"].dtype == np.uint8
    assert psnr(golden["image"], img_r) >= 40.0
    assert psnr(golden["image"], _port_frame()[0]) >= 40.0
    assert json.loads(str(golden["caps"]))["matq_classic_cap"] > 0


# --- the sky worklist ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sphere_inputs(static_sky: bool):
    """A sphere over the gradient-cubemap sky, 256x96 (the scene of the
    reference's tests/test_render.py:474); without static_sky the sky is
    sampled through the descriptor tables."""
    scene = Scene()
    model = add_pbr_sphere(scene, stacks=24, slices=24)
    base = gradient_cubemap(scene, size=16)
    uniforms = make_uniforms(Camera(position=np.array([0.0, 0.25, 2.3], np.float32)), 256, 96)
    state = port_build(scene, [(model, math3d.Similarity())], uniforms, device="cpu")
    env = EnvBindings.from_scene(scene, ambient_sh=default_ambient_sh(), ibl_cubemap_base=base)
    if not static_sky:
        env = dataclasses.replace(env, ibl_cubemap_static=None)
    return scene_to_torch(scene, "cpu"), state, env


@pytest.mark.parametrize("static_sky", [True, False])
def test_sky_worklist_matches_fullscreen(static_sky):
    """The sky worklist (sky_px_cap) evaluates the skybox on uncovered
    pixels only: the image equals the full-screen sky's byte for byte and
    sky_px_needed agrees, with 32-px granules and per pixel; a cap below
    the need blackens dropped sky pixels and still reports the need (the
    reference's tests/test_render.py:497)."""
    dev, state, env = _sphere_inputs(static_sky)
    base = dict(width=256, height=96, t_cap=2048, t_cap_anim=8, opaque_px_cap=12288,
                granule_px=32)

    def frame(**kw):
        img, stats = port_frame.render_frame_stats(dev, state, RenderConfig(**base, **kw), env)
        return img, port_frame.stats_to_host(stats)["sky_px_needed"]

    img_full, need = frame()
    assert 0 < need < 256 * 96 and need % 32 == 0
    img_wl, need_wl = frame(sky_px_cap=need)
    assert need_wl == need and torch.equal(img_full, img_wl)
    img_px, need_px = frame(sky_px_cap=need, worklist_granules=False)
    assert 0 < need_px <= need and torch.equal(img_full, img_px)
    img_of, need_of = frame(sky_px_cap=need // 4)
    assert need_of == need and not torch.equal(img_full, img_of)

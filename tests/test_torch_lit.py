"""Light volumes, lightmaps and the smoke pool: the port against the
reference on the same inputs.

- the samplers (sample_lightvol_sh, sample_lightmap_sh,
  sample_3d_from_layers, sample_smoke_interleaved) on the lit scene's own
  pools, at points inside, on the edge of and outside the probe box and at
  uv outside [0, 1] (clamp);
- sample_spherical_harmonics with the light volume, the lightmaps or both
  (a mixed lightmapped mask), each on the SH-interleaved pools and layered
  through the HDR pool; the port's pooled and layered paths within 2e-6 of
  each other, as the reference's tests hold its own;
- shade_particles with the smoke pool and with the classic per-slot smoke
  path, and the port's smoke-pool frame byte-equal to its classic frame;
- the environment loaders on KTX2 files written in memory (RGBA8, RGBA8
  sRGB and RGBA16F, volumes with depth > 1): every device table bit for bit;
- without the speed pools (quad_pools off, or dropped by the texture
  budget) no pool key is published, on either side;
- the 256x128 lit_passes frame against the reference rendered in an
  AVX-capped child, and the golden chip_smoke.py holds the card against.

Tolerances as in tests/test_torch_shade.py: samplers rtol 1e-5 / atol 1e-6
(the lerps are written in the reference's operand order; XLA contracts
them into FMAs in process, so the last bits may differ), shaded colour
rtol 1e-4 / atol 2e-5, frames >= 40 dB with equal stats."""

import dataclasses
import functools
import json
import os
import struct
import subprocess
import sys
import tempfile
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_tpu.assets import environment as ref_environment
from superconductor_tpu.ops import particles as ref_particles
from superconductor_tpu.ops import shade as ref_shade
from superconductor_tpu.ops import texture as ref_texture
from superconductor_tpu.scene.scene import Scene as RefScene
from superconductor_tpu.utils.metrics import psnr
from superconductor_tpu_torch.assets import environment as port_environment
from superconductor_tpu_torch.ops import particles as port_particles
from superconductor_tpu_torch.ops import shade as port_shade
from superconductor_tpu_torch.ops import texture as port_texture
from superconductor_tpu_torch.render import frame as port_frame
from superconductor_tpu_torch.render.caps import fit_caps
from superconductor_tpu_torch.render.camera import Camera, make_uniforms
from superconductor_tpu_torch.render.draws import build_frame_state, pack_particles
from superconductor_tpu_torch.render.env import EnvBindings
from superconductor_tpu_torch.render.frame import RenderConfig
from superconductor_tpu_torch.scene.scene import TEXFLAG_SRGB, WRAP_CLAMP, WRAP_REPEAT, Scene
from superconductor_tpu_torch.scene.upload import scene_to_torch
from superconductor_tpu_torch.scenes import LIGHTVOL_DIMS, LIT_PASSES_SMALL, lit_passes_host
from test_torch_host import REF_HOST, assert_same
from test_torch_upload import _assert_same_tables

# The test workers share the CPU: torch's default of a thread per core in
# each of them oversubscribes it many times over.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "torch_lit_passes_256x128.npz")
ANGLE = 0.3  # sphere turn of the golden frame
REGEN = bool(os.environ.get("SC_REGEN_GOLDENS"))
POOL_KEYS = ("lv_sh", "lm_sh", "smoke_ab", "smoke_lut")


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _host():
    """The small lit scene built by the port's host layer."""
    return lit_passes_host(**LIT_PASSES_SMALL)


@functools.lru_cache(maxsize=None)
def _tables():
    """(reference tables, port tables, env, uniforms dict): the small lit
    scene's device_arrays() and scene_to_torch, each built by its own host
    layer (equal bit for bit, tests/test_torch_upload.py)."""
    ref = lit_passes_host(**LIT_PASSES_SMALL, host=REF_HOST)
    return ref[0].device_arrays(), scene_to_torch(_host()[0], "cpu"), ref[3], \
        ref[2].as_device_dict()


def _box_points(seed: int, p: int = 4096) -> np.ndarray:
    """Normalised probe-box coordinates in [-0.3, 1.3]: inside, outside
    (clamped layers and texels) and, for a sixteenth of them, exactly on a
    face of the box."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.3, 1.3, size=(p, 3)).astype(np.float32)
    edge = rng.integers(0, 3, size=p // 16)
    pts[np.arange(p // 16), edge] = rng.integers(0, 2, size=p // 16)
    return pts


def _uvs(seed: int, p: int = 4096) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-0.2, 1.2, size=(p, 2)).astype(np.float32)


@pytest.mark.parametrize("sampler", ["lightvol_sh", "lightmap_sh", "3d_from_layers",
                                     "smoke_clamp", "smoke_repeat"])
def test_samplers_match_reference(sampler):
    """Each new sampler on the lit scene's pools, the same lanes on both
    sides: rtol 1e-5 / atol 1e-6."""
    dev_r, dev_p, env, _u = _tables()
    w, h, z = LIGHTVOL_DIMS
    if sampler == "lightvol_sh":
        pts = _box_points(1)
        ref = ref_texture.sample_lightvol_sh(dev_r["lv_sh"], w, h, z, jnp.asarray(pts))
        port = port_texture.sample_lightvol_sh(dev_p["lv_sh"], w, h, z, _t(pts))
    elif sampler == "lightmap_sh":
        uv = _uvs(2)
        lw, lh = env.lightmap_wh
        ref = ref_texture.sample_lightmap_sh(dev_r["lm_sh"], lw, lh, jnp.asarray(uv))
        port = port_texture.sample_lightmap_sh(dev_p["lm_sh"], lw, lh, _t(uv))
    elif sampler == "3d_from_layers":
        pts = _box_points(3)
        ids = np.repeat(np.asarray(env.lightvol_tex_ids, np.int32), pts.shape[0] // 4)
        ref = ref_texture.sample_3d_from_layers(
            ref_texture.hdr_pool(dev_r), dev_r["tex_hdr"], jnp.asarray(ids), jnp.asarray(pts), z)
        port = port_texture.sample_3d_from_layers(
            port_texture.hdr_pool(dev_p), dev_p["tex_hdr"], _t(ids), _t(pts), z)
    else:
        uv = _uvs(4)
        sw, sh, wrap = env.smoke_static[:3]
        assert wrap == WRAP_CLAMP
        wrap = WRAP_CLAMP if sampler == "smoke_clamp" else WRAP_REPEAT
        ref = ref_texture.sample_smoke_interleaved(dev_r["smoke_ab"], sw, sh, wrap, jnp.asarray(uv))
        port = port_texture.sample_smoke_interleaved(dev_p["smoke_ab"], sw, sh, wrap, _t(uv))
    port = port.numpy()
    assert np.isfinite(port).all() and np.abs(port).max() > 0
    np.testing.assert_allclose(port, np.asarray(ref), rtol=1e-5, atol=1e-6)


def _sh_inputs(which: str, path: str, seed: int = 5, p: int = 4096):
    """(dev_r, dev_p, env, gbuffer fields, uniforms) for one SH case:
    `which` the textures bound (volume, lightmap, both), `path` the
    SH-interleaved pools or the layered samplers (pools dropped)."""
    dev_r, dev_p, env, u = _tables()
    if which == "volume":
        env = dataclasses.replace(env, lightmap_tex_ids=None, lightmap_wh=None)
    elif which == "lightmap":
        env = dataclasses.replace(env, lightvol_tex_ids=None, lightvol_wh=None)
    if path == "layered":
        dev_r = {k: v for k, v in dev_r.items() if k not in POOL_KEYS}
        dev_p = {k: v for k, v in dev_p.items() if k not in POOL_KEYS}
    bl, scale = u["probes_bottom_left"], u["probes_scale"]
    rng = np.random.default_rng(seed)
    g = dict(
        world_pos=(bl + _box_points(seed, p) * scale).astype(np.float32),
        lm_uv=_uvs(seed + 1, p), lightmapped=rng.uniform(size=p) < 0.5,
    )
    return dev_r, dev_p, env, g, u


def _sh(mod, gbuf_fields, dev, uniforms, env, to):
    g = {f: None for f in mod.GBuffer._fields}
    g.update({k: to(v) for k, v in gbuf_fields.items()})
    return mod.sample_spherical_harmonics(mod.GBuffer(**g), dev, {k: to(v) for k, v in uniforms.items()}, env)


@pytest.mark.parametrize("path", ["pools", "layered"])
@pytest.mark.parametrize("which", ["volume", "lightmap", "both"])
def test_sample_spherical_harmonics_matches_reference(which, path):
    """(P, 4, 3) SH on the same lanes: world positions inside, on and
    outside the probe box, lm_uv in [-0.2, 1.2], half the lanes
    lightmapped; rtol 1e-5 / atol 1e-6 on values up to 2."""
    dev_r, dev_p, env, g, u = _sh_inputs(which, path)
    ref = np.asarray(_sh(ref_shade, g, dev_r, u, env, jnp.asarray))
    port = _sh(port_shade, g, dev_p, u, env, _t).numpy()
    assert port.shape == (4096, 4, 3) and np.isfinite(port).all()
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)
    if which == "both":  # the merge took each lane's own source
        lone = _sh(port_shade, g, dev_p, u, dataclasses.replace(env, lightmap_tex_ids=None), _t)
        np.testing.assert_array_equal(port[~g["lightmapped"]], lone.numpy()[~g["lightmapped"]])


@pytest.mark.parametrize("which", ["volume", "lightmap"])
def test_pooled_sh_matches_layered(which):
    """The port's SH-interleaved path against its layered path: the same
    texels and lerps in another grouping, held within 2e-6 as the
    reference holds its own (tests/test_ktx2.py:202)."""
    _r, dev_p, env, g, u = _sh_inputs(which, "pools")
    _r, dev_l, _e, _g, _u = _sh_inputs(which, "layered")
    pooled = _sh(port_shade, g, dev_p, u, env, _t).numpy()
    layered = _sh(port_shade, g, dev_l, u, env, _t).numpy()
    np.testing.assert_allclose(pooled, layered, rtol=0, atol=2e-6)


@pytest.mark.parametrize("path", ["pool", "classic"])
def test_shade_particles_smoke_matches_reference(path):
    """shade_particles on the lit scene's particles (half of them reading
    the emissive LUT), lit by its light volume, with the smoke maps on the
    smoke pool or sampled per slot from the LDR quad pool: colour at rtol
    1e-4 / atol 2e-5, alpha at rtol 1e-5 / atol 1e-6."""
    scene, _inst, uniforms, _env, config, draw_kw = _host()
    dev_r, dev_p, env, u = _tables()
    if path == "classic":
        dev_r = {k: v for k, v in dev_r.items() if not k.startswith("smoke")}
        dev_p = {k: v for k, v in dev_p.items() if not k.startswith("smoke")}
    soa = draw_kw["particles"]
    size = (config.width, config.height)
    mats = [np.asarray(u[k][0]) for k in ("view", "view_inverse", "projection")]
    soa_r = {k: jnp.asarray(v) for k, v in soa.items()}
    soa_p = {k: _t(v) for k, v in soa.items()}
    tri, attrs = ref_particles.particle_geometry(soa_r, *[jnp.asarray(m) for m in mats], *size)
    rng = np.random.default_rng(9)
    valid = np.where(np.asarray(tri.valid))[0]
    p = 2048
    pair = rng.choice(valid, size=p).astype(np.int32)
    pair[::23] = -1
    box = np.asarray(tri.bbox)[np.maximum(pair, 0)]
    px = rng.integers(box[:, 0], box[:, 2] + 1).astype(np.float32) + 0.5
    py = rng.integers(box[:, 1], box[:, 3] + 1).astype(np.float32) + 0.5
    u_r = {k: jnp.asarray(v) for k, v in u.items()}
    u_p = {k: _t(np.asarray(v, np.float32)) for k, v in u.items()}

    def sampler(mod, dev, uu, to):
        def sh(world_pos):
            g = {f: None for f in mod.GBuffer._fields}
            n = world_pos.shape[0]
            g.update(world_pos=world_pos, lm_uv=to(np.zeros((n, 2), np.float32)),
                     lightmapped=to(np.zeros(n, bool)))
            return mod.sample_spherical_harmonics(mod.GBuffer(**g), dev, uu, env)
        return sh

    rgb_r, a_r = ref_particles.shade_particles(
        jnp.asarray(pair), jnp.asarray(px), jnp.asarray(py), tri, attrs, soa_r, dev_r, u_r,
        env, 0, sampler(ref_shade, dev_r, u_r, jnp.asarray))
    attrs_p = port_particles.ParticleAttrs(*[None if x is None else _t(x) for x in attrs])
    tri_p = tri._replace(**{k: _t(getattr(tri, k)) for k in tri._fields})
    rgb_p, a_p = port_particles.shade_particles(
        _t(pair), _t(px), _t(py), tri_p, attrs_p, soa_p, dev_p, u_p, env, 0,
        sampler(port_shade, dev_p, u_p, _t))
    np.testing.assert_allclose(rgb_p.numpy(), np.asarray(rgb_r), rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(a_p.numpy(), np.asarray(a_r), rtol=1e-5, atol=1e-6)
    a = a_p.numpy()
    assert (a[pair >= 0] > 0).any() and (a[pair < 0] == 0).all()
    lut = np.asarray(soa["use_emissive_lut"])[attrs_p.particle[np.maximum(pair, 0)].numpy()] != 0
    assert lut[pair >= 0].any() and (~lut[pair >= 0]).any()


def test_smoke_pool_frame_equals_classic_frame():
    """The port's twin of the reference's
    tests/test_lines_particles.py:166: two particles, one reading the
    emissive LUT, over seeded 64^2 smoke maps and a 32^2 sRGB LUT. The
    frame on the smoke pool equals byte for byte the frame with the pool
    removed (the maps and LUT sampled per slot from the LDR quad pool)."""
    rng = np.random.default_rng(5)

    def tex(size, lo=0, hi=255):
        return rng.integers(lo, hi, (size, size, 4), np.uint8)

    scene = Scene()
    a_id = scene.textures.add_texture([tex(64)], wrap=WRAP_CLAMP)
    b_id = scene.textures.add_texture([tex(64, lo=40)], wrap=WRAP_CLAMP)
    lut_id = scene.textures.add_texture([tex(32)], wrap=WRAP_CLAMP, flags=TEXFLAG_SRGB)
    scene.smoke_tex = (a_id, b_id, lut_id)
    uniforms = make_uniforms(Camera(position=np.array([0.3, 0.4, 4.0], np.float32)), 192, 96)
    parts = [
        {"center": [-0.6, 0.1, -0.8], "scale": [1.6, 1.4],
         "colour": [0.9, 0.85, 0.95], "emissive_colour": [0.4, 0.25, 0.1]},
        {"center": [0.5, -0.2, 0.0], "scale": [1.8, 1.8],
         "colour": [0.8, 0.9, 1.0], "emissive_colour": [0.5, 0.4, 0.6],
         "use_emissive_lut": 1, "lut_y": 0.35},
    ]
    state = build_frame_state(scene, [], uniforms, particles=pack_particles(parts), device="cpu")
    config = RenderConfig(width=192, height=96, enable_particles=True)
    env = EnvBindings.from_scene(
        scene, ambient_sh=(0.6, 0.6, 0.65, 0.2, 0.1, 0.1, 0.2, 0.2, 0.2, 0.1, 0.1, 0.1))
    assert env.smoke_static is not None
    dev = scene_to_torch(scene, "cpu")
    assert dev["smoke_ab"].shape == (64 * 64, 32) and dev["smoke_lut"].shape == (32 * 32, 16)
    img_pool = port_frame.render_frame(dev, state, config, env)[0]
    classic = {k: v for k, v in dev.items() if not k.startswith("smoke")}
    img_classic = port_frame.render_frame(classic, state, config, env)[0]
    assert (img_pool[..., :3] > 0).any()
    assert torch.equal(img_pool, img_classic)


# --- the environment loaders --------------------------------------------

def _ktx2(vk_format: int, images: list, depth: int = 0, faces: int = 1) -> bytes:
    """An uncompressed KTX2 file of one level: `images` (each (h, w, 4)
    u8 or f16) are the level's z slices or faces in KTX2 order (the
    reference's tests/test_texture_lifecycle.py:19 writer, with depth and
    faces)."""
    h, w = images[0].shape[:2]
    header = struct.pack("<9I", vk_format, images[0].dtype.itemsize, w, h, depth, 0, faces, 1, 0)
    payload = b"".join(np.ascontiguousarray(i).tobytes() for i in images)
    index_off = 12 + 48 + 20 + 24
    return (b"\xabKTX 20\xbb\r\n\x1a\n" + header + struct.pack("<4I2Q", 0, 0, 0, 0, 0, 0)
            + struct.pack("<3Q", index_off, len(payload), len(payload)) + payload)


def _rgba8(rng, n, h, w):
    return [rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8) for _ in range(n)]


def _rgba16f(rng, n, h, w):
    return [rng.uniform(0.0, 3.0, size=(h, w, 4)).astype(np.float16) for _ in range(n)]


def _loader_files(which: str):
    """(loader name, KTX2 files, keywords) of one environment loader."""
    rng = np.random.default_rng(13)
    if which == "lightvol":  # 12x8x6 volumes: L0 RGBA16F, L1 bands RGBA8
        files = [_ktx2(97, _rgba16f(rng, 6, 8, 12), depth=6)]
        files += [_ktx2(37, _rgba8(rng, 6, 8, 12), depth=6) for _ in range(3)]
        return "load_lightvol", files, dict(bottom_left=(-2.0, 0.0, -1.0), scale=(4.0, 2.0, 3.0))
    if which == "lightmaps":
        files = [_ktx2(97, _rgba16f(rng, 1, 16, 24))]
        files += [_ktx2(37, _rgba8(rng, 1, 16, 24)) for _ in range(3)]
        return "load_lightmaps", files, {}
    if which == "smoke":  # two RGBA8 maps and an sRGB (vkFormat 43) LUT
        files = [_ktx2(37, _rgba8(rng, 1, 32, 32)) for _ in range(2)]
        files.append(_ktx2(43, _rgba8(rng, 1, 4, 64)))
        return "load_smoke_textures", files, {}
    return "load_ibl_cubemap", [_ktx2(97, _rgba16f(rng, 6, 8, 8), faces=6)], {}


@pytest.mark.parametrize("which", ["lightvol", "lightmaps", "smoke", "ibl_cubemap"])
def test_environment_loaders_match_reference(which):
    """assets/environment.py against the reference's on the same KTX2
    bytes: the same return value and, after upload, every device table bit
    for bit (the texel pools, the descriptors and the SH / smoke pools)."""
    name, files, kw = _loader_files(which)
    ref_scene, port_scene = RefScene(), Scene()
    out_r = getattr(ref_environment, name)(ref_scene, *files, **kw)
    out_p = getattr(port_environment, name)(port_scene, *files, **kw)
    assert_same(out_r, out_p, name)
    ref, port = ref_scene.device_arrays(), scene_to_torch(port_scene, "cpu")
    _assert_same_tables(ref, port)
    assert {"lightvol": "lv_sh", "lightmaps": "lm_sh", "smoke": "smoke_ab"}.get(which, "tex") in port
    env = EnvBindings.from_scene(port_scene)
    if which == "lightvol":
        assert env.lightvol_wh == (12, 8) and env.lightvol_z_layers == 6
    elif which == "smoke":
        assert env.smoke_static == (32, 32, WRAP_CLAMP, 64, 4, WRAP_CLAMP, TEXFLAG_SRGB)


@pytest.mark.parametrize("drop", ["quad_pools_off", "texture_budget"])
def test_no_pool_without_quad_pools(drop):
    """With quad_pools off, or the speed pools dropped by the texture
    budget's first step, neither side publishes lv_sh, lm_sh or the smoke
    pool, and the tables stay equal: the frame then takes the layered SH
    and classic smoke branches, which the tests above hold."""
    scenes = []
    for host in (REF_HOST, None):
        scene = lit_passes_host(64, 32, n_spheres=3, stacks=8, lightmap_size=32,
                                smoke_size=32, **({"host": host} if host else {}))[0]
        if drop == "quad_pools_off":
            scene.quad_pools = False
        else:
            scene.texture_budget_bytes = scene.projected_texture_bytes(quad=False) + 1
        scenes.append(scene)
    ref, port = scenes[0].device_arrays(), scene_to_torch(scenes[1], "cpu")
    assert not scenes[1].quad_pools
    assert not set(POOL_KEYS) & set(port) and "texels_q" not in port
    _assert_same_tables(ref, port)


# --- the 256x128 lit frame ----------------------------------------------

def _state():
    scene, instances, uniforms, _env, _config, draw_kw = _host()
    return build_frame_state(scene, instances(ANGLE), uniforms, device="cpu", **draw_kw)


@functools.lru_cache(maxsize=None)
def _fitted():
    """The port's fit_caps on the small frame -> (config, grow per round)."""
    rounds = []
    config = fit_caps(_tables()[1], _state(), _host()[4], _host()[3],
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
    from superconductor_tpu_torch.scenes import LIT_PASSES_SMALL, lit_passes_host
    sys.path.insert(0, "tests")
    from test_torch_host import REF_HOST

    caps, angle = json.loads(sys.argv[2]), float(sys.argv[3])
    caps = {k: tuple(v) if isinstance(v, list) else v for k, v in caps.items()}
    scene, instances, uniforms, env, config, draw_kw = lit_passes_host(
        **LIT_PASSES_SMALL, host=REF_HOST)
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
    backend is capped at AVX (so the jitted reference rounds its setup rows
    op by op, as the port does; tests/test_torch_all_passes.py). The child
    runs while the tests do the port's side; the callable waits for it."""
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
    img, stats = port_frame.render_frame_stats(_tables()[1], _state(), config, _host()[3])
    return img.numpy(), port_frame.stats_to_host(stats)


def test_lit_frame_matches_reference(reference):
    """At the capacities the port's fit_caps gives (stored with the
    golden): PSNR >= 40 dB and the stats dict equal, with the light volume,
    the lightmapped wall, the smoke pool and the material-path partition
    (the wall's untextured material joins the interleaved pool; the
    terrain's still cannot) all engaged."""
    config, rounds = _fitted()
    assert _caps(config) == _golden_caps()
    assert {"matq_classic_cap", "particle_layers", "shade_px_caps"} <= set().union(*rounds)
    dev = _tables()[1]
    assert set(POOL_KEYS) <= set(dev) and not bool(dev["matq_capable"].all())
    img_p, stats_p = _port_frame()
    img_r, stats_r = reference()
    assert img_p.dtype == np.uint8 and img_p.shape == img_r.shape == (1, 128, 256, 4)
    db = psnr(img_r, img_p)
    assert db >= 40.0, db
    assert stats_r == stats_p
    assert _golden_caps()["matq_classic_cap"] >= stats_p["matq_classic_needed"] > 0
    assert stats_p["particle_layers_needed"] >= 1


def test_lit_golden_is_the_reference_frame(reference):
    """tests/goldens/torch_lit_passes_256x128.npz holds the reference's lit
    frame at 256x128 (spheres at 0.3 rad, raster="pallas"), the capacities
    it was rendered with (those the port's fit_caps gives) and its stats.
    chip_smoke.py holds the card's frame and stats against it. Regenerate
    with SC_REGEN_GOLDENS=1."""
    img_r, stats_r = reference()
    if REGEN:
        np.savez_compressed(GOLDEN, image=img_r, caps=json.dumps(_golden_caps()),
                            stats=json.dumps(stats_r))
    golden = np.load(GOLDEN)
    assert golden["image"].shape == (1, 128, 256, 4) and golden["image"].dtype == np.uint8
    assert psnr(golden["image"], img_r) >= 40.0
    assert psnr(golden["image"], _port_frame()[0]) >= 40.0
    assert json.loads(str(golden["caps"]))["matq_classic_cap"] > 0
    assert json.loads(str(golden["stats"])) == stats_r == _port_frame()[1]

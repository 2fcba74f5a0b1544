"""The lines and particles passes' own pieces against the reference's, on
the same inputs: the pack helpers, the line quads' and the particle
billboards' setup rows (bit for bit against the reference run eagerly, op
by op: the jitted reference contracts multiply-adds into FMAs, see
tests/test_torch_geometry.py), and the particle shading on the same rows.

Inputs are the all-passes frame's 22 grid lines and 16 particles plus
segments and particles drawn from a numpy seed (some behind the camera,
some degenerate), seen by the all-passes camera at two resolutions."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_tpu.ops import lines as ref_lines
from superconductor_tpu.ops import particles as ref_particles
from superconductor_tpu.ops import shade as ref_shade
from superconductor_tpu.render import draws as ref_draws
from superconductor_tpu_torch.ops import lines as port_lines
from superconductor_tpu_torch.ops import particles as port_particles
from superconductor_tpu_torch.ops import shade as port_shade
from superconductor_tpu_torch.render import draws as port_draws
from superconductor_tpu_torch.scenes import _aim, all_passes_overlays
from test_torch_host import REF_HOST

# The test workers share the CPU: torch's default of a thread per core in
# each of them oversubscribes it many times over.
torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _camera(width: int, height: int):
    """The all-passes frame's uniforms at width x height (its camera at
    (8, 2.5, 3) aimed at (0, 1.2, 0), bench.py:624) and an env with its
    constant ambient SH, from the reference's host layer."""
    cam = REF_HOST.Camera(position=np.array([8.0, 2.5, 3.0], np.float32))
    _aim(cam, [0, 1.2, 0], REF_HOST.math3d)
    uniforms = REF_HOST.make_uniforms(cam, width, height)
    return uniforms.as_device_dict(), REF_HOST.EnvBindings(ambient_sh=REF_HOST.default_ambient_sh())


def _segments(seed: int):
    """The grid lines, then 42 seeded segments: some long, some crossing
    behind the camera, two of zero length."""
    grid = all_passes_overlays()["lines"]
    rng = np.random.default_rng(seed)
    extra = rng.uniform(-9.0, 9.0, size=(42, 2, 3)).astype(np.float32)
    extra[:2, 1] = extra[:2, 0]
    segs = np.concatenate([grid["pos"][:22], extra])
    colors = np.concatenate([np.arange(22), rng.integers(0, 40, size=42)]).astype(np.int32)
    return segs, colors


def _particles(seed: int):
    """The 16 all-passes particles and 30 seeded ones (scales, uv transforms,
    emissive LUT flags), as pack_particles dicts."""
    base = [dict(p) for p in _particle_dicts()]
    rng = np.random.default_rng(seed)
    for i in range(30):
        base.append({
            "center": rng.uniform(-6.0, 6.0, size=3).tolist(),
            "scale": rng.uniform(0.05, 3.0, size=2).tolist(),
            "colour": rng.uniform(0.0, 1.0, size=3).tolist(),
            "uv_offset": rng.uniform(-0.2, 0.2, size=2).tolist(),
            "uv_scale": rng.uniform(0.5, 1.5, size=2).tolist(),
            "emissive_colour": rng.uniform(0.0, 0.5, size=3).tolist(),
            "use_emissive_lut": int(i % 3 == 0),
            "lut_y": float(rng.uniform()),
        })
    return base


def _particle_dicts():
    k = np.arange(16)
    return [{"center": [3.0 * np.cos(0.8 * i), 1.0 + 0.2 * i, 3.0 * np.sin(0.8 * i)],
             "scale": [1.5, 1.5], "colour": [0.9, 0.9, 0.95],
             "emissive_colour": [0.3, 0.2, 0.1]} for i in k]


def _assert_bits(a, b, name):
    a, b = np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, name
    assert np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                          np.ascontiguousarray(b).view(np.uint8)), name


def test_pack_helpers_match_reference():
    """pack_lines / pack_particles (and their empty forms) equal the
    reference's array for array; all_passes_overlays is bench.py's data."""
    segs, colors = _segments(3)
    for cap in (None, 128):
        ref = ref_draws.pack_lines(segs.tolist(), colors.tolist(), cap=cap)
        port = port_draws.pack_lines(segs.tolist(), colors.tolist(), cap=cap)
        for k in ref:
            _assert_bits(ref[k], port[k], k)
    dicts = _particles(4)
    for ref, port in ((ref_draws.pack_particles(dicts), port_draws.pack_particles(dicts)),
                      (ref_draws.pack_particles(), port_draws.pack_particles()),
                      (ref_draws.pack_lines([], []), port_draws.pack_lines([], []))):
        assert sorted(ref) == sorted(port)
        for k in ref:
            _assert_bits(ref[k], port[k], k)
    overlays = all_passes_overlays()
    assert int(overlays["lines"]["valid"].sum()) == 22
    assert int(overlays["particles"]["valid"].sum()) == 16
    _assert_bits(ref_draws.pack_particles(_particle_dicts())["center"],
                 overlays["particles"]["center"], "center")


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("size", [(256, 128), (1920, 1080)])
def test_line_setup_rows_bit_exact(size, flip):
    """line_geometry: setup rows, bounding boxes, valid flags, ids and
    colours of every quad triangle equal the eager reference's bit for bit
    (near-plane drops and zero-length segments included)."""
    uniforms, _env = _camera(*size)
    segs, colors = _segments(5)
    valid = np.ones(segs.shape[0], bool)
    valid[-3] = False
    vp = uniforms["view_proj"][0]
    tri_r, col_r = ref_lines.line_geometry(
        jnp.asarray(segs), jnp.asarray(colors), jnp.asarray(valid), jnp.asarray(vp),
        *size, line_width_px=1.5, flip_viewport=flip)
    tri_p, col_p = port_lines.line_geometry(
        _t(segs), _t(colors), _t(valid), _t(vp), *size, line_width_px=1.5, flip_viewport=flip)
    for name in tri_r._fields:
        _assert_bits(getattr(tri_r, name), getattr(tri_p, name), name)
    _assert_bits(col_r, col_p, "colors")
    v = tri_p.valid.numpy()
    assert 22 <= v.sum() < v.shape[0]


def _particle_inputs(size):
    uniforms, env = _camera(*size)
    soa = port_draws.pack_particles(_particles(6))
    soa["valid"][-2] = False
    return uniforms, env, soa


@pytest.mark.parametrize("size", [(256, 128), (1920, 1080)])
def test_particle_setup_rows_bit_exact(size):
    """particle_geometry: billboard setup rows, boxes, flags, ids, corner
    uvs and world positions, and the packed per-pair shading rows equal
    the eager reference's bit for bit."""
    uniforms, _env, soa = _particle_inputs(size)
    mats = [uniforms[k][0] for k in ("view", "view_inverse", "projection")]
    tri_r, attrs_r = ref_particles.particle_geometry(
        {k: jnp.asarray(v) for k, v in soa.items()}, *[jnp.asarray(m) for m in mats], *size)
    tri_p, attrs_p = port_particles.particle_geometry(
        {k: _t(v) for k, v in soa.items()}, *[_t(m) for m in mats], *size)
    for name in tri_r._fields:
        _assert_bits(getattr(tri_r, name), getattr(tri_p, name), name)
    for name in attrs_r._fields:
        _assert_bits(getattr(attrs_r, name), getattr(attrs_p, name), name)
    assert 0 < int(tri_p.valid.sum()) < tri_p.valid.shape[0]


@pytest.mark.parametrize("packed", [True, False])
def test_shade_particles_matches_reference(packed):
    """shade_particles on the same billboard rows (the reference's) and
    pixel centres inside each quad's bounding box, with the SH sampler
    over a stand-in g-buffer as the frame builds it: colour at rtol 1e-5 /
    atol 2e-6 (sqrt, rsqrt and the sRGB encode's pow differ by an ulp
    between torch and XLA), alpha at rtol 1e-5 / atol 1e-6; from the
    packed row or from the separate tables."""
    size = (256, 128)
    uniforms, env, soa = _particle_inputs(size)
    mats = [uniforms[k][0] for k in ("view", "view_inverse", "projection")]
    soa_r = {k: jnp.asarray(v) for k, v in soa.items()}
    soa_p = {k: _t(v) for k, v in soa.items()}
    tri, attrs = ref_particles.particle_geometry(soa_r, *[jnp.asarray(m) for m in mats], *size)
    if not packed:
        attrs = attrs._replace(packed=None)
    rng = np.random.default_rng(9)
    valid = np.where(np.asarray(tri.valid))[0]
    p = 2048
    pair = rng.choice(valid, size=p).astype(np.int32)
    pair[::23] = -1
    box = np.asarray(tri.bbox)[np.maximum(pair, 0)]
    px = (rng.integers(box[:, 0], box[:, 2] + 1)).astype(np.float32) + 0.5
    py = (rng.integers(box[:, 1], box[:, 3] + 1)).astype(np.float32) + 0.5
    u_r = {k: jnp.asarray(v) for k, v in uniforms.items()}
    u_p = {k: _t(np.asarray(v, np.float32)) for k, v in uniforms.items()}

    def sh_ref(world_pos):
        stand_in = ref_shade.GBuffer(
            valid=None, world_pos=world_pos, normal=None, uv=None,
            lm_uv=jnp.zeros_like(world_pos[..., :2]), material=None, front_facing=None,
            lightmapped=jnp.zeros(world_pos.shape[0], bool), dpdx=None, dpdy=None,
            duvdx=None, duvdy=None)
        return ref_shade.sample_spherical_harmonics(stand_in, {}, u_r, env)

    def sh_port(world_pos):
        stand_in = port_shade.GBuffer(
            valid=None, world_pos=world_pos, normal=None, uv=None,
            lm_uv=torch.zeros_like(world_pos[..., :2]), material=None, front_facing=None,
            lightmapped=torch.zeros(world_pos.shape[0], dtype=torch.bool), dpdx=None,
            dpdy=None, duvdx=None, duvdy=None)
        return port_shade.sample_spherical_harmonics(stand_in, {}, u_p, env)

    rgb_r, a_r = ref_particles.shade_particles(
        jnp.asarray(pair), jnp.asarray(px), jnp.asarray(py), tri, attrs, soa_r, {}, u_r, env,
        0, sh_ref)
    attrs_p = port_particles.ParticleAttrs(*[None if x is None else _t(x) for x in attrs])
    tri_p = tri._replace(**{k: _t(getattr(tri, k)) for k in tri._fields})
    rgb_p, a_p = port_particles.shade_particles(
        _t(pair), _t(px), _t(py), tri_p, attrs_p, soa_p, {}, u_p, env, 0, sh_port)
    np.testing.assert_allclose(rgb_p.numpy(), np.asarray(rgb_r), rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(a_p.numpy(), np.asarray(a_r), rtol=1e-5, atol=1e-6)
    a = a_p.numpy()
    assert (a[pair >= 0] > 0).any() and (a[pair < 0] == 0).all()

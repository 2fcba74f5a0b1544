"""The port's tonemap, texture sampling, g-buffer interpolation and shade
against the reference's JAX functions (run eagerly, op by op) on identical
inputs made with numpy or taken from the hero fixture.

Tolerances and their reasons: elementwise arithmetic is written in the
reference's operand order, so most results agree to the last bit
(measured: g-buffer interpolation, the static cubemap sampler, ACES and
the exact sRGB encode). Where they do not, the cause is the math library:
pow, log2 and rsqrt differ between XLA's CPU kernels and torch's by an
ulp (measured: the sRGB decode, 3e-5 abs on values up to ~390), so
functions are compared at rtol 1e-5. Shading chains several such
functions through the tonemap (measured 1.8e-6 abs), so the shaded colour
is compared at atol 2e-5 on values in [0, 1] (well under one u8 step,
1/255)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_tpu.math3d import Similarity, quat_from_axis_angle
from superconductor_tpu.ops import shade as ref_shade
from superconductor_tpu.ops import texture as ref_texture
from superconductor_tpu.ops import tonemap as ref_tonemap
from superconductor_tpu.render import frame as ref_frame
from superconductor_tpu.render.draws import build_frame_state
from superconductor_tpu_torch.ops import shade as port_shade
from superconductor_tpu_torch.ops.geometry import TriangleAttrs, TriangleSetup
from superconductor_tpu_torch.ops import texture as port_texture
from superconductor_tpu_torch.ops import tonemap as port_tonemap
from superconductor_tpu_torch.scene.upload import scene_to_torch
from superconductor_tpu_torch.scenes import headline_host
from test_torch_host import REF_HOST

# The test workers share the CPU: torch's default of a thread per core in
# each of them oversubscribes it many times over.
torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _hero():
    """The hero scene twice: built by the reference's host layer (its
    tables `dev`, env) and by the port's (its tables `dev_t`, env_t)."""
    scene, model, uniforms, env, config = headline_host(256, 128, host=REF_HOST)
    scene_t, _model, _uniforms, env_t, _config = headline_host(256, 128)
    return (scene, model, uniforms, env, config, scene.device_arrays(),
            scene_to_torch(scene_t, "cpu"), env_t)


@pytest.mark.parametrize(
    "name", ["aces_filmic", "linear_to_srgb_approx", "srgb_to_linear_exact",
             "linear_to_srgb_exact", "tonemap_and_encode"],
)
def test_tonemap_matches_reference(name):
    x = np.random.default_rng(1).uniform(-0.5, 12.0, size=4096).astype(np.float32)
    x[:8] = [0.0, 1.0, 0.04045, 0.0031308, -0.0, 0.5, 2.0, 1e-7]
    ref = np.asarray(getattr(ref_tonemap, name)(jnp.asarray(x)))
    port = getattr(port_tonemap, name)(_t(x)).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["_srgb_decode", "mip_level_from_derivatives"])
def test_texture_helpers_match_reference(name):
    rng = np.random.default_rng(6)
    if name == "_srgb_decode":
        args = (rng.uniform(0, 1, size=(4096, 4)).astype(np.float32),
                rng.integers(0, 4, size=4096).astype(np.int32))
    else:
        args = tuple((rng.normal(size=4096) * 10.0 ** rng.uniform(-5, 0, size=4096))
                     .astype(np.float32) for _ in range(4)) + (512.0, 256.0)
    ref = np.asarray(getattr(ref_texture, name)(*[jnp.asarray(a) for a in args]))
    port = getattr(port_texture, name)(*[_t(a) if isinstance(a, np.ndarray) else a
                                         for a in args]).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)


def test_to_u8_is_exact():
    """Rounding is half to even in both; identical inputs, identical bytes."""
    x = np.random.default_rng(2).uniform(-0.2, 1.2, size=(64, 64, 4)).astype(np.float32)
    x[0, :8, 0] = np.array([0.5, 1.5, 2.5, 127.5, 128.5, 254.5, 255.5, 3.5]) / 255.0
    assert np.array_equal(np.asarray(ref_tonemap.to_u8(jnp.asarray(x))),
                          port_tonemap.to_u8(_t(x)).numpy())


def test_sample_cubemap_static_matches_reference():
    _s, _m, _u, env, _c, dev, dev_t, env_t = _hero()
    rng = np.random.default_rng(3)
    d = rng.normal(size=(8192, 3)).astype(np.float32)
    d[:6] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]
    d[6:10] = [[1, 1, 0], [1, 1, 1], [0, -1, -1], [-2, 2, 0]]  # face ties
    ref = np.asarray(ref_texture.sample_cubemap(
        ref_texture.hdr_pool(dev), dev["tex_hdr"], env.ibl_cubemap_base,
        jnp.asarray(d), static=env.ibl_cubemap_static,
    ))
    port = port_texture.sample_cubemap(
        port_texture.hdr_pool(dev_t), dev_t["tex_hdr"], env_t.ibl_cubemap_base,
        _t(d), static=env_t.ibl_cubemap_static,
    ).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("taps", [1, 4])
def test_sample_material_interleaved_matches_reference(taps):
    """Both hero materials, uv inside and outside [0, 1] (wrap), and
    footprints from below one texel to the whole chain (every mip level,
    both the main and the tail pool)."""
    _s, _m, _u, _e, _c, dev, dev_t, _e_t = _hero()
    rng = np.random.default_rng(4 + taps)
    p = 4096
    mat = rng.integers(0, 2, size=p).astype(np.int32)
    uv = rng.uniform(-1.0, 2.0, size=(p, 2)).astype(np.float32)
    scale = (10.0 ** rng.uniform(-5, 0.5, size=(p, 1))).astype(np.float32)
    dx = (rng.normal(size=(p, 2)) * scale).astype(np.float32)
    dy = (rng.normal(size=(p, 2)) * scale).astype(np.float32)
    rows = np.asarray(dev["materials"]["mat_row_mq"])[mat]
    _pf, _pi, meta, owh = ref_shade._unpack_mq_row(jnp.asarray(rows))
    ref = np.asarray(ref_texture.sample_material_interleaved(
        dev["texels_mq"], meta, owh, jnp.asarray(uv), jnp.asarray(dx),
        jnp.asarray(dy), taps, texels_tail=dev["texels_mq_tail"],
    ))
    _pf, _pi, meta_t, owh_t = port_shade._unpack_mq_row(_t(rows))
    port = port_texture.sample_material_interleaved(
        dev_t["texels_mq"], meta_t, owh_t, _t(uv), _t(dx), _t(dy), taps,
        texels_tail=dev_t["texels_mq_tail"],
    ).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _hero_gbuffer_inputs():
    """Shade rows of the hero at 256x128 (reference geometry, jitted: these
    are inputs, fed to both sides) plus pixel lanes that hit and miss."""
    scene, model, uniforms, _env, config, dev, _dev_t, _env_t = _hero()
    from dataclasses import asdict

    rcfg = ref_frame.RenderConfig(**{**asdict(config), "raster": "pallas"})
    state = build_frame_state(
        scene, [(model, Similarity(rotation=quat_from_axis_angle([0, 1, 0], 0.3)))],
        uniforms,
    )
    tri, attrs = jax.jit(
        lambda dev, state: ref_frame._merged_geometry(
            dev, state, state.uniforms["view_proj"][0], rcfg
        )
    )(dev, state)
    mats = dev["materials"]
    shade_row = jnp.concatenate(
        [tri.setup, attrs.packed, mats["mat_row_mq"][attrs.material]], axis=1
    )
    valid = np.where(np.asarray(tri.valid))[0]
    rng = np.random.default_rng(5)
    p = 4096
    pair = rng.choice(valid, size=p).astype(np.int32)
    pair[::17] = -1
    # pixel centres near each triangle: its bbox centre, jittered
    bbox = np.asarray(tri.bbox)[np.maximum(pair, 0)]
    px = ((bbox[:, 0] + bbox[:, 2]) // 2 + rng.integers(-2, 3, size=p)).astype(np.float32) + 0.5
    py = ((bbox[:, 1] + bbox[:, 3]) // 2 + rng.integers(-2, 3, size=p)).astype(np.float32) + 0.5
    return state, tri, attrs, np.asarray(shade_row), pair, px, py


def _port_gbuffer(g):
    return port_shade.GBuffer(*[None if x is None else _t(x) for x in g])


@pytest.mark.parametrize("with_shade_row", [True, False])
def test_interpolate_gbuffer_matches_reference(with_shade_row):
    """Same rows, same lanes: from the fused shade row, or from the setup
    and packed attribute tables. Interpolated attributes rtol 1e-5; the
    analytic derivatives divide by the squared edge sum and are compared
    at rtol 1e-4 / atol 1e-6 of their own scale."""
    _state, tri, attrs, shade_row, pair, px, py = _hero_gbuffer_inputs()
    ref = ref_shade.interpolate_gbuffer(
        jnp.asarray(pair), jnp.asarray(px), jnp.asarray(py), tri, attrs,
        shade_row=jnp.asarray(shade_row) if with_shade_row else None,
    )
    port_tri = TriangleSetup(*[_t(x) for x in tri])
    port_attrs = TriangleAttrs(*[_t(x) for x in attrs])
    port = port_shade.interpolate_gbuffer(
        _t(pair), _t(px), _t(py), port_tri, port_attrs,
        shade_row=_t(shade_row) if with_shade_row else None,
    )
    if not with_shade_row:
        assert ref.mat_tail is None and port.mat_tail is None
        ref, port = ref._replace(mat_tail=0), port._replace(mat_tail=torch.tensor(0))
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if a.dtype != np.float32:
            assert np.array_equal(a, b), f
        elif f.startswith("d"):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6 * np.abs(a).max(), err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("inline", [True, False])
def test_shade_matches_reference(inline):
    """shade() on the SAME g-buffer (the reference's, carried across)."""
    state, tri, attrs, shade_row, pair, px, py = _hero_gbuffer_inputs()
    _s, _m, _u, env, _c, dev, dev_t, env_t = _hero()
    g = ref_shade.interpolate_gbuffer(
        jnp.asarray(pair), jnp.asarray(px), jnp.asarray(py), tri, attrs,
        shade_row=jnp.asarray(shade_row),
    )
    u = {k: jnp.asarray(v) for k, v in state.uniforms.items()}
    rgb_r, a_r = ref_shade.shade(g, dev, u, 0, env=env, inline_tonemapping=inline,
                                 inline_srgb=inline)
    u_t = {k: _t(np.asarray(v, np.float32)) for k, v in state.uniforms.items()}
    rgb_p, a_p = port_shade.shade(_port_gbuffer(g), dev_t, u_t, 0, env=env_t,
                                  inline_tonemapping=inline, inline_srgb=inline)
    rgb_r = np.asarray(rgb_r)
    assert np.isfinite(rgb_p.numpy()).all()
    np.testing.assert_allclose(rgb_p.numpy(), rgb_r, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(a_p.numpy(), np.asarray(a_r), rtol=1e-5, atol=1e-6)
    assert (rgb_r[pair >= 0] > 0).any()

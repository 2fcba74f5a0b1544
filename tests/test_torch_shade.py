"""The port's tonemap, texture sampling, g-buffer interpolation and shade
against the reference's JAX functions (run eagerly, op by op) on identical
inputs made with numpy or taken from the hero fixture and the all-passes
scene (whose terrain material only the classic samplers take).

Tolerances and their reasons: elementwise arithmetic is written in the
reference's operand order, so most results agree to the last bit
(measured: g-buffer interpolation, the static cubemap sampler, ACES and
the exact sRGB encode). Where they do not, the cause is the math library:
pow, log2 and rsqrt differ between XLA's CPU kernels and torch's by an
ulp (measured: the sRGB decode, 3e-5 abs on values up to ~390), so
functions are compared at rtol 1e-5. The samplers' lod takes a log2, so
the trilinear fraction moves by an ulp where the two log2s differ
(measured on the classic samplers: up to 3e-7 abs on linear slots, 2e-6 on
sRGB ones where the decode's pow adds its ulp; no level flipped in 8,192
lanes a slot), hence rtol 1e-5 / atol 1e-6 for every sampler. Shading
chains several such functions through the tonemap (measured 1.8e-6 abs),
so the shaded colour is compared at atol 2e-5 on values in [0, 1] (well
under one u8 step, 1/255)."""

import functools
from types import SimpleNamespace

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
from superconductor_tpu_torch.render import frame as port_frame
from superconductor_tpu_torch.scene.upload import scene_to_torch
from superconductor_tpu_torch.scenes import ALL_PASSES_SMALL, all_passes_host, headline_host
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


def _matq_scene(mod, size, wrap):
    """One material of four seeded size^2 textures, albedo and emissive
    sRGB (the reference's tests/test_matq.py _full_material_scene), in
    scene module `mod`."""
    scene = mod.Scene()
    ids = []
    for seed, flags in ((1, mod.TEXFLAG_SRGB), (2, 0), (3, 0), (4, mod.TEXFLAG_SRGB)):
        img = np.random.default_rng(seed).integers(0, 255, (size, size, 4), np.uint8)
        ids.append(scene.textures.add_texture(mod.build_mip_chain(img), wrap=wrap, flags=flags))
    scene.add_material(mod.MaterialSettings(
        albedo_tex=ids[0], normal_tex=ids[1], metallic_roughness_tex=ids[2], emissive_tex=ids[3],
    ))
    return scene


# the reference's tests/test_matq.py:141-195: (size, wrap, taps, seed,
# derivative scale); the last two push lod past the chain end, where the
# second level pairs with the last one
MQ3_CASES = {
    "real-slots": (64, 0, 1, 9, 0.2),
    "clamp-1-tap": (32, 1, 1, 11, 0.2),
    "clamp-4-taps": (32, 1, 4, 11, 0.2),
    "self-pair-repeat": (32, 0, 1, 13, 4.0),
    "self-pair-clamp": (32, 1, 1, 13, 4.0),
}


@pytest.mark.parametrize("mq3", [True, False])
@pytest.mark.parametrize("case", sorted(MQ3_CASES))
def test_mq3_sampling_matches_classic_and_reference(case, mq3):
    """sample_material_interleaved on the wide mq3 rows (Scene.matq3x3)
    and on the 64 B rows equals the port's four classic per-slot samples
    bit for bit, as the reference's two paths agree in its own tests; and
    the reference's interleaved sample at the samplers' rtol 1e-5 / atol
    1e-6 (the lod's log2)."""
    from superconductor_tpu.scene import scene as ref_scene_mod
    from superconductor_tpu_torch.scene import scene as port_scene_mod

    size, wrap, taps, seed, dscale = MQ3_CASES[case]
    ref_sc, port_sc = _matq_scene(ref_scene_mod, size, wrap), _matq_scene(port_scene_mod, size, wrap)
    ref_sc.matq3x3 = port_sc.matq3x3 = mq3
    dev, dev_t = ref_sc.device_arrays(), scene_to_torch(port_sc, "cpu")
    assert dev_t["texels_mq"].shape[-1] == (208 if mq3 else 64)
    rng = np.random.default_rng(seed)
    p = 4096
    mat = np.zeros(p, np.int32)
    uv = rng.uniform(-1.5, 2.5, (p, 2)).astype(np.float32)
    dx = rng.uniform(-dscale, dscale, (p, 2)).astype(np.float32)
    dy = rng.uniform(-dscale, dscale, (p, 2)).astype(np.float32)
    _pf, _pi, meta, owh = ref_shade._material_rows_mq(dev["materials"], jnp.asarray(mat))
    ref = np.asarray(ref_texture.sample_material_interleaved(
        dev["texels_mq"], meta, owh, jnp.asarray(uv), jnp.asarray(dx), jnp.asarray(dy), taps,
        texels_tail=dev.get("texels_mq_tail"),
    ))
    m = dev_t["materials"]
    _pf, _pi, meta_t, owh_t = port_shade._material_rows_mq(m, _t(mat))
    port = port_texture.sample_material_interleaved(
        dev_t["texels_mq"], meta_t, owh_t, _t(uv), _t(dx), _t(dy), taps,
        texels_tail=dev_t.get("texels_mq_tail"),
    ).numpy()
    _pfc, pic, mtm, mlv = port_shade._material_rows(m, _t(mat))
    for slot in range(4):
        classic = port_texture.sample_anisotropic(
            port_texture.ldr_pool(dev_t), dev_t["tex"], pic[..., slot], _t(uv), _t(dx), _t(dy),
            taps, meta=mtm[..., 6 * slot:6 * slot + 6], levels_owh=mlv[..., slot, :, :],
        ).numpy()
        np.testing.assert_array_equal(port[:, 4 * slot:4 * slot + 4], classic, err_msg=str(slot))
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


@pytest.mark.parametrize("layout", ["padded", "no_tail"])
def test_interpolate_gbuffer_row_layouts_match_reference(layout):
    """The hero's fused shade row padded to 128 columns (row_cols, as
    shade_row_pad leaves it) and cut to its 48 setup and packed columns (a
    scene without the interleaved material rows: no tail), at the
    tolerances of test_interpolate_gbuffer_matches_reference."""
    _state, tri, attrs, shade_row, pair, px, py = _hero_gbuffer_inputs()
    row_cols = None
    if layout == "padded":
        row_cols = shade_row.shape[1]
        shade_row = np.pad(shade_row, ((0, 0), (0, 128 - row_cols)))
    else:
        shade_row = np.ascontiguousarray(shade_row[:, :48])
    ref = ref_shade.interpolate_gbuffer(
        jnp.asarray(pair), jnp.asarray(px), jnp.asarray(py), tri, attrs,
        shade_row=jnp.asarray(shade_row), row_cols=row_cols,
    )
    port = port_shade.interpolate_gbuffer(
        _t(pair), _t(px), _t(py), TriangleSetup(*[_t(x) for x in tri]),
        TriangleAttrs(*[_t(x) for x in attrs]), shade_row=_t(shade_row), row_cols=row_cols,
    )
    assert (ref.mat_tail is None) == (port.mat_tail is None) == (layout == "no_tail")
    for f in ref._fields:
        if getattr(ref, f) is None:
            continue
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if a.dtype != np.float32 or f == "mat_tail":
            assert np.array_equal(a.view(np.int32) if f == "mat_tail" else a,
                                  b.view(np.int32) if f == "mat_tail" else b), f
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


# --- the classic samplers, the partition, on the all-passes tables -------

@functools.lru_cache(maxsize=None)
def _all_passes():
    """The all-passes scene's tables, the reference's (device_arrays) and
    the port's (scene_to_torch): material 0 is the terrain's (512^2 albedo,
    256^2 normal: not interleavable), 1-8 the spheres'."""
    return (all_passes_host(**ALL_PASSES_SMALL, host=REF_HOST)[0].device_arrays(),
            scene_to_torch(all_passes_host(**ALL_PASSES_SMALL)[0], "cpu"))


def _sampler_lanes(seed: int, p: int = 4096):
    """uv inside and outside [0, 1] and footprints from under a texel to
    the whole chain (every mip level, and lod < 0)."""
    rng = np.random.default_rng(seed)
    scale = (10.0 ** rng.uniform(-5, 0.5, size=(p, 1))).astype(np.float32)
    return (rng.uniform(-1.0, 2.0, size=(p, 2)).astype(np.float32),
            (rng.normal(size=(p, 2)) * scale).astype(np.float32),
            (rng.normal(size=(p, 2)) * scale).astype(np.float32))


DESCRIPTOR_PATHS = ("levels", "mip_owh2", "tex_meta", "flat")


def _descriptors(path, tex, mtm, mlv, slot):
    """The tex_desc and keywords of one of sample_trilinear's descriptor
    paths: the material row's in-register mip table, the mip_owh2 pair
    rows with the row's meta, the tex_meta + mip_owh2 tables, or the flat
    per-field tables (two bilinear_level calls)."""
    if path == "levels":
        return tex, dict(meta=mtm[..., 6 * slot:6 * slot + 6], levels_owh=mlv[..., slot, :, :])
    if path == "mip_owh2":
        return tex, dict(meta=mtm[..., 6 * slot:6 * slot + 6])
    if path == "tex_meta":
        return tex, {}
    return {k: v for k, v in tex.items() if k not in ("tex_meta", "mip_owh", "mip_owh2")}, {}


@pytest.mark.parametrize("path", DESCRIPTOR_PATHS)
@pytest.mark.parametrize("taps", [1, 4])
@pytest.mark.parametrize("material", ["terrain", "sphere"])
def test_classic_samplers_match_reference(material, taps, path):
    """sample_anisotropic (taps 1: trilinear at the isotropic lod; 4: four
    trilinear taps along the major axis) on all four slots of the
    terrain's and a clipped sphere's material, through each descriptor path
    of sample_trilinear, on the same tables: rtol 1e-5 / atol 1e-6 (the
    lod's log2 and the sRGB decode's pow, module docstring)."""
    dev_r, dev_p = _all_passes()
    mat = np.full(4096, 0 if material == "terrain" else 2, np.int32)
    uv, dx, dy = _sampler_lanes(11 + taps)
    _pf, pi_r, mtm_r, mlv_r = ref_shade._material_rows(dev_r["materials"], jnp.asarray(mat))
    _pf, pi_p, mtm_p, mlv_p = port_shade._material_rows(dev_p["materials"], _t(mat))
    for slot in range(4):
        desc_r, kw_r = _descriptors(path, dev_r["tex"], mtm_r, mlv_r, slot)
        desc_p, kw_p = _descriptors(path, dev_p["tex"], mtm_p, mlv_p, slot)
        ref = np.asarray(ref_texture.sample_anisotropic(
            ref_texture.ldr_pool(dev_r), desc_r, pi_r[..., slot], jnp.asarray(uv),
            jnp.asarray(dx), jnp.asarray(dy), taps, **kw_r))
        port = port_texture.sample_anisotropic(
            port_texture.ldr_pool(dev_p), desc_p, pi_p[..., slot], _t(uv), _t(dx), _t(dy),
            taps, **kw_p).numpy()
        np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6, err_msg=f"slot {slot}")


@pytest.mark.parametrize("lod", [None, "varying"])
def test_sample_cubemap_through_descriptors_matches_reference(lod):
    """The cubemap sampler without static placement: one bilinear tap at
    the base level (lod None), or trilinear at a per-lane lod, through the
    HDR pool's descriptor tables."""
    _s, _m, _u, env, _c, dev, dev_t, env_t = _hero()
    rng = np.random.default_rng(8)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    lods = rng.uniform(-1.0, 7.0, size=4096).astype(np.float32)
    ref = np.asarray(ref_texture.sample_cubemap(
        ref_texture.hdr_pool(dev), dev["tex_hdr"], env.ibl_cubemap_base, jnp.asarray(d),
        lod=None if lod is None else jnp.asarray(lods),
    ))
    port = port_texture.sample_cubemap(
        port_texture.hdr_pool(dev_t), dev_t["tex_hdr"], env_t.ibl_cubemap_base, _t(d),
        lod=None if lod is None else _t(lods),
    ).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)


def _partition_lanes(seed: int, p: int = 2048):
    """Lanes on every material of the all-passes scene (numpy seed), a few
    invalid; -> (lanes, incapable valid lanes)."""
    capable = np.asarray(_all_passes()[0]["matq_capable"])
    assert not capable.all() and capable.any()
    uv, dx, dy = _sampler_lanes(seed, p)
    rng = np.random.default_rng(seed + 100)
    lanes = dict(uv=uv, duvdx=dx, duvdy=dy,
                 material=rng.integers(0, capable.shape[0], size=p).astype(np.int32),
                 valid=rng.uniform(size=p) > 0.05)
    return lanes, int(((~capable[lanes["material"]]) & lanes["valid"]).sum())


@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("slots", [None, (0,)])
def test_partition_material_sample_matches_reference(spill, slots):
    """render/frame.py _partition_material_sample on the same lanes and
    tables (the reference's tests/test_matq.py:334 and :381 on the
    all-passes pool): classic_needed equal, the samples at rtol 1e-5 /
    atol 1e-6. With a classic segment a quarter of the need, the incapable
    lanes that spill into the interleaved segment read the sentinel row on
    both sides alike."""
    from superconductor_tpu.render.frame import _partition_material_sample as ref_partition

    dev_r, dev_p = _all_passes()
    lanes, need = _partition_lanes(7 + spill)
    cap = max(1, need // 4) if spill else need + 64
    s_r, n_r = ref_partition(
        SimpleNamespace(**{k: jnp.asarray(v) for k, v in lanes.items()}), dev_r,
        ref_frame.RenderConfig(matq_classic_cap=cap), 1, slots=slots)
    s_p, n_p = port_frame._partition_material_sample(
        SimpleNamespace(**{k: _t(v) for k, v in lanes.items()}), dev_p,
        port_frame.RenderConfig(matq_classic_cap=cap), 1, slots=slots)
    assert int(n_p) == int(n_r) == need > (cap if spill else 0)
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_r), rtol=1e-5, atol=1e-6)


def test_classic_shade_and_albedo_alpha_match_reference():
    """On the partial pool, shade() and albedo_alpha() without pre-sampled
    textures take the classic sampler for every lane, and with the
    partition's samples (s16 / albedo4) use them with the material row's
    factors: the shaded colour at rtol 1e-4 / atol 2e-5, alpha and the
    cutoff at rtol 1e-5 / atol 1e-6, both ways, against the reference."""
    from superconductor_tpu.render.frame import _partition_material_sample as ref_partition

    taps = 1  # the samplers' 4-tap path is held in test_classic_samplers_match_reference
    dev_r, dev_p = _all_passes()
    lanes, need = _partition_lanes(20 + taps, p=1024)
    p = lanes["material"].shape[0]
    rng = np.random.default_rng(30 + taps)
    normal = rng.normal(size=(p, 3)).astype(np.float32)
    g = dict(
        valid=lanes["valid"], world_pos=rng.normal(size=(p, 3)).astype(np.float32),
        normal=normal, uv=lanes["uv"], lm_uv=np.zeros((p, 2), np.float32),
        material=lanes["material"], front_facing=rng.uniform(size=p) > 0.3,
        lightmapped=np.zeros(p, bool),
        dpdx=(rng.normal(size=(p, 3)) * 1e-2).astype(np.float32),
        dpdy=(rng.normal(size=(p, 3)) * 1e-2).astype(np.float32),
        duvdx=lanes["duvdx"], duvdy=lanes["duvdy"],
    )
    g_r = ref_shade.GBuffer(**{k: jnp.asarray(v) for k, v in g.items()})
    g_p = port_shade.GBuffer(**{k: _t(v) for k, v in g.items()})
    _s, _m, uniforms, env, _c, _dev, _dev_t, env_t = _hero()
    u = {k: jnp.asarray(v) for k, v in uniforms.as_device_dict().items()}
    u_t = {k: _t(np.asarray(v, np.float32)) for k, v in uniforms.as_device_dict().items()}
    cfg_r = ref_frame.RenderConfig(matq_classic_cap=need + 64, aniso_taps=taps)
    cfg_p = port_frame.RenderConfig(matq_classic_cap=need + 64, aniso_taps=taps)
    s16_r, _n = ref_partition(g_r, dev_r, cfg_r, taps)
    s16_p, _n = port_frame._partition_material_sample(g_p, dev_p, cfg_p, taps)
    for pre in (False, True):
        rgb_r, a_r = ref_shade.shade(g_r, dev_r, u, 0, env=env, aniso_taps=taps,
                                     s16=s16_r if pre else None)
        rgb_p, a_p = port_shade.shade(g_p, dev_p, u_t, 0, env=env_t, aniso_taps=taps,
                                      s16=s16_p if pre else None)
        np.testing.assert_allclose(rgb_p.numpy(), np.asarray(rgb_r), rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(a_p.numpy(), np.asarray(a_r), rtol=1e-5, atol=1e-6)
        al_r, c_r = ref_shade.albedo_alpha(g_r, dev_r, aniso_taps=taps,
                                           albedo4=s16_r[..., 0:4] if pre else None)
        al_p, c_p = port_shade.albedo_alpha(g_p, dev_p, aniso_taps=taps,
                                            albedo4=s16_p[..., 0:4] if pre else None)
        np.testing.assert_allclose(al_p.numpy(), np.asarray(al_r), rtol=1e-5, atol=1e-6)
        assert np.array_equal(c_p.numpy(), np.asarray(c_r))

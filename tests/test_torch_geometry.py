"""The port's draw build and geometry stage against the reference's, fed
identical scenes: DrawLists and uniforms from build_frame_state, then the
merged vertex stage and per-view setup rows (_merged_vertex_stage /
_merged_setup_for_view)."""

import functools
from dataclasses import asdict

import jax
import numpy as np
import pytest
import torch

from superconductor_tpu.math3d import (
    Similarity,
    look_at,
    mat3_to_quat,
    mat4_inverse,
    quat_from_axis_angle,
)
from superconductor_tpu.render import frame as ref_frame
from superconductor_tpu.render.camera import Camera, make_uniforms
from superconductor_tpu.render.draws import build_frame_state as ref_build
from superconductor_tpu.scene.scene import Scene
from superconductor_tpu.utils.procgen import add_skinned_tube, wave_joint_palette
from superconductor_tpu_torch.render import frame as port_frame
from superconductor_tpu_torch.render.draws import build_frame_state as port_build
from superconductor_tpu_torch.render.frame import RenderConfig
from superconductor_tpu_torch.scene.upload import arrays_to_torch
from superconductor_tpu_torch.scenes import headline_host

ANGLES = [0.0, 0.7, 2.5]


@pytest.fixture(scope="module")
def hero():
    return headline_host(256, 128)


def _ref_config(config: RenderConfig):
    return ref_frame.RenderConfig(**{**asdict(config), "raster": "pallas"})


def _both_states(scene, instances, uniforms, **kw):
    return ref_build(scene, instances, uniforms, **kw), port_build(
        scene, instances, uniforms, **kw
    )


@functools.lru_cache(maxsize=None)
def _ref_geometry_fn(rcfg):
    """The reference's geometry for one config, jitted (`__wrapped__` is
    the eager function). Eager JAX rounds every op like the port; under
    jit XLA fuses the graph and contracts multiply-adds into FMAs."""

    def geometry(dev, state):
        st, at = ref_frame._merged_vertex_stage(dev, state, rcfg)
        tri = ref_frame._merged_setup_for_view(st, state.uniforms["view_proj"][0], rcfg)
        return st, at, tri

    jitted = jax.jit(geometry)
    jitted.__wrapped__ = geometry
    return jitted


def _geometry(dev, dev_t, ref_state, port_state, config, jit=False):
    """Reference (eager op by op, or one jitted program) and port geometry."""
    fn = _ref_geometry_fn(_ref_config(config))
    st_r, at_r, tri_r = (fn if jit else fn.__wrapped__)(dev, ref_state)
    st_p, at_p = port_frame._merged_vertex_stage(dev_t, port_state, config)
    tri_p = port_frame._merged_setup_for_view(
        st_p, port_state.uniforms["view_proj"][0], config
    )
    return (st_r, at_r, tri_r), (st_p, at_p, tri_p)


@pytest.mark.parametrize("angle", ANGLES)
def test_build_frame_state_matches_reference(hero, angle):
    scene, model, uniforms, _env, _config = hero
    sim = Similarity(rotation=quat_from_axis_angle([0, 1, 0], angle))
    ref, port = _both_states(scene, [(model, sim)], uniforms)
    for name in ("draws_static", "draws_animated"):
        r, p = getattr(ref, name), getattr(port, name)
        for field in r._fields:
            a, b = np.asarray(getattr(r, field)), getattr(p, field).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, field)
    for k, v in ref.uniforms.items():
        assert np.array_equal(np.asarray(v, np.float32), port.uniforms[k].numpy()), k
    assert np.array_equal(ref.joint_palette, port.joint_palette.numpy())


@pytest.mark.parametrize("angle", ANGLES)
def test_setup_rows_bit_exact_on_hero(hero, angle):
    """Against the reference evaluated op by op. Tolerance: none. The clip
    transform is written in the reference's CPU dot order, so clip
    coordinates, setup rows, bboxes and packed attributes are
    bit-identical on every valid pair. Invalid padding rows
    of the animated stage are NaN in both (zero skinning weights), with
    unspecified NaN payloads, so they compare as NaN-equal."""
    scene, model, uniforms, _env, config = hero
    dev = scene.device_arrays()
    dev_t = arrays_to_torch(dev)
    sim = Similarity(rotation=quat_from_axis_angle([0, 1, 0], angle))
    ref_state, port_state = _both_states(scene, [(model, sim)], uniforms)
    (st_r, at_r, tri_r), (st_p, at_p, tri_p) = _geometry(
        dev, dev_t, ref_state, port_state, config
    )
    valid = np.asarray(tri_r.valid)
    assert valid.sum() > 1000
    assert np.array_equal(valid, tri_p.valid.numpy())
    assert np.array_equal(np.asarray(tri_r.bbox), tri_p.bbox.numpy())
    a, b = np.asarray(tri_r.setup), tri_p.setup.numpy()
    assert np.array_equal(a[valid].view(np.int32), b[valid].view(np.int32))
    assert np.array_equal(a, b, equal_nan=True)
    pa, pb = np.asarray(at_r.packed), at_p.packed.numpy()
    assert np.array_equal(pa[valid].view(np.int32), pb[valid].view(np.int32))
    for f in ("tri_id", "inst_id"):
        assert np.array_equal(np.asarray(getattr(tri_r, f)), getattr(tri_p, f).numpy())
    assert int(tri_r.num_valid) == int(tri_p.num_valid)


def _skinned_geometry(jit: bool):
    """A skinned tube bent by a joint palette, through both packages."""
    scene = Scene()
    model = add_skinned_tube(scene, segments=12, slices=8)
    cam = Camera(position=np.array([0.0, 1.0, 4.0], np.float32))
    cam.rotation = mat3_to_quat(mat4_inverse(look_at(cam.position, [0, 1.0, 0]))[:3, :3])
    uniforms = make_uniforms(cam, 128, 96)
    pal = wave_joint_palette(0.8, 8, amp=0.6)
    config = RenderConfig(width=128, height=96, t_cap=16, t_cap_anim=512)
    dev = scene.device_arrays()
    dev_t = arrays_to_torch(dev)
    ref_state, port_state = _both_states(
        scene, [(model, Similarity())], uniforms, joint_palettes={0: pal}
    )
    return _geometry(dev, dev_t, ref_state, port_state, config, jit=jit)


def test_skinned_setup_rows_bit_exact():
    """Skinning, the animated vertex stage and its setup rows against the
    reference evaluated op by op. Tolerance: none."""
    (st_r, at_r, tri_r), (st_p, at_p, tri_p) = _skinned_geometry(jit=False)
    valid = np.asarray(tri_r.valid)
    assert valid.sum() > 50
    assert np.array_equal(valid, tri_p.valid.numpy())
    assert np.array_equal(np.asarray(st_r[1].w1), st_p[1].w1.numpy(), equal_nan=True)
    assert np.array_equal(np.asarray(tri_r.bbox), tri_p.bbox.numpy())
    for a, b in ((tri_r.setup, tri_p.setup), (at_r.packed, at_p.packed)):
        a, b = np.asarray(a)[valid], b.numpy()[valid]
        assert np.array_equal(a.view(np.int32), b.view(np.int32))


def test_skinned_vertex_stage_matches_jitted_reference():
    """Skinned geometry against the reference under jit, where XLA fuses
    and contracts multiply-adds into FMAs, so positions may differ by an
    ulp. Tolerance: world positions and packed attributes rtol 1e-6 / atol
    1e-6; edge coefficients are differences of near-equal products, so an
    ulp in a clip coordinate moves them by up to ~1e-4 of their row's
    largest coefficient: compared at 1e-3 of it. The valid mask must
    agree, and bboxes within one pixel."""
    (st_r, at_r, tri_r), (st_p, at_p, tri_p) = _skinned_geometry(jit=True)
    np.testing.assert_allclose(
        np.asarray(st_r[1].w1), st_p[1].w1.numpy(), rtol=1e-6, atol=1e-6
    )
    valid = np.asarray(tri_r.valid)
    assert valid.sum() > 50
    assert np.array_equal(valid, tri_p.valid.numpy())
    np.testing.assert_allclose(
        np.asarray(at_r.packed)[valid], at_p.packed.numpy()[valid], rtol=1e-6, atol=1e-6
    )
    a, b = np.asarray(tri_r.setup)[valid], tri_p.setup.numpy()[valid]
    scale = np.abs(a[:, :9]).max(axis=1, keepdims=True)
    assert (np.abs(a[:, :9] - b[:, :9]) <= 1e-3 * scale).all()
    np.testing.assert_allclose(a[:, 9:], b[:, 9:], rtol=1e-6, atol=1e-6)
    db = np.abs(np.asarray(tri_r.bbox)[valid] - tri_p.bbox.numpy()[valid])
    assert db.max() <= 1


def test_geometry_ragged_expansion_matches_repeat():
    """ragged_owner == jnp.repeat(arange(n), counts, total_repeat_length=cap)
    for totals below, at and above the capacity, including zero counts."""
    import jax.numpy as jnp

    from superconductor_tpu_torch.ops.geometry import ragged_owner

    rng = np.random.default_rng(3)
    for cap in (1, 7, 40, 200):
        counts = rng.integers(0, 6, size=17).astype(np.int32)
        counts[[0, 5, 16]] = 0
        ref = np.asarray(
            jnp.repeat(jnp.arange(17, dtype=jnp.int32), jnp.asarray(counts),
                       total_repeat_length=cap)
        )
        owner, ok, _off, total = ragged_owner(torch.from_numpy(counts), cap)
        n = min(int(counts.sum()), cap)
        assert int(total) == int(counts.sum())
        assert np.array_equal(owner.numpy()[:n], ref[:n])
        assert ok.numpy().sum() == n


def test_box_geometry_pass_matches_reference(box_glb):
    """A draw list made with each package's make_draw_list, through the
    vertex stage and view setup: bit-exact against the eager reference
    (tests/test_raster_pallas.py's box at 96x256)."""
    import jax.numpy as jnp

    from superconductor_tpu.assets.models import load_model
    from superconductor_tpu.ops import geometry as ref_geom
    from superconductor_tpu_torch.ops import geometry as port_geom

    scene = Scene()
    model = load_model(scene, box_glb, name="box")
    uniforms = make_uniforms(Camera(position=np.array([0.6, 0.8, 2.0], np.float32)), 256, 96)
    sim = Similarity(rotation=quat_from_axis_angle([0, 1, 0], 0.6))
    prim, lod = model.primitives[0], model.primitives[0].lods[0]
    args = (sim.to_array()[None], np.array([lod.first_index // 3]),
            np.array([lod.index_count // 3]))
    kw = dict(first_vertex=np.array([lod.first_vertex]),
              vertex_count=np.array([lod.vertex_count]), material=np.array([prim.material]))
    dev = scene.device_arrays()
    dev_t = arrays_to_torch(dev)
    keys = ("indices", "positions", "normals", "uvs", "lightmap_uvs", "tri_material", "materials")
    tri_r, attrs_r = ref_geom.geometry_pass(
        ref_geom.make_draw_list(*args, **kw), *[dev[k] for k in keys],
        jnp.asarray(uniforms.view_proj[0]), 256, 96, t_cap=16,
    )
    stage = port_geom.geometry_vertex_stage(
        port_geom.make_draw_list(*args, **kw), *[dev_t[k] for k in keys], 16
    )
    tri_p = port_geom.geometry_view_setup(stage, torch.from_numpy(uniforms.view_proj[0]), 256, 96)
    for f in tri_r._fields:
        a, b = np.asarray(getattr(tri_r, f)), getattr(tri_p, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), f
    assert np.array_equal(np.asarray(attrs_r.packed), stage.attrs.packed.numpy())
    assert np.asarray(tri_r.valid).sum() == 6

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

import superconductor_tpu.math3d as ref_math3d
from superconductor_tpu.render import camera as ref_camera
from superconductor_tpu.render import frame as ref_frame
from superconductor_tpu.render.draws import build_frame_state as ref_build
from superconductor_tpu.scene.scene import Scene
from superconductor_tpu.utils import procgen as ref_procgen
from superconductor_tpu_torch import math3d as port_math3d
from superconductor_tpu_torch.render import camera as port_camera
from superconductor_tpu_torch.render import frame as port_frame
from superconductor_tpu_torch.render.draws import build_frame_state as port_build
from superconductor_tpu_torch.render.frame import RenderConfig
from superconductor_tpu_torch.scene.scene import Scene as PortScene
from superconductor_tpu_torch.scene.upload import scene_to_torch
from superconductor_tpu_torch.scenes import headline_host
from superconductor_tpu_torch.utils import procgen as port_procgen
from test_torch_host import REF_HOST, numpy_joint_update

# The test workers share the CPU: torch's default of a thread per core in
# each of them oversubscribes it many times over.
torch.set_num_threads(2)

ANGLES = [0.0, 0.7, 2.5]


@pytest.fixture(scope="module")
def hero():
    """The hero scene built by the reference's host layer and by the
    port's."""
    return headline_host(256, 128, host=REF_HOST), headline_host(256, 128)


def _ref_config(config: RenderConfig):
    return ref_frame.RenderConfig(**{**asdict(config), "raster": "pallas"})


def _turned(m3, angle):
    return m3.Similarity(rotation=m3.quat_from_axis_angle([0, 1, 0], angle))


def _both_states(ref, port, **kw):
    """FrameStates of (scene, instances, uniforms) built by each package
    from its own host objects."""
    return ref_build(*ref, **kw), port_build(*port, device="cpu", **kw)


def _hero_states(hero, angle):
    (scene_r, model_r, uni_r, _e, _c), (scene_p, model_p, uni_p, _e, _c) = hero
    return _both_states((scene_r, [(model_r, _turned(ref_math3d, angle))], uni_r),
                        (scene_p, [(model_p, _turned(port_math3d, angle))], uni_p))


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
    ref, port = _hero_states(hero, angle)
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
    config = hero[0][4]
    dev = hero[0][0].device_arrays()
    dev_t = scene_to_torch(hero[1][0], "cpu")
    ref_state, port_state = _hero_states(hero, angle)
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
    """A skinned tube bent by a joint palette, through both packages, each
    building it with its own host layer, its palette from the numpy FK on
    both sides (tests/test_torch_host.py holds the palettes equal on each
    FK path)."""
    sides = []
    for scene_cls, procgen, m3, camera in (
        (Scene, ref_procgen, ref_math3d, ref_camera),
        (PortScene, port_procgen, port_math3d, port_camera),
    ):
        scene = scene_cls()
        model = procgen.add_skinned_tube(scene, segments=12, slices=8)
        cam = camera.Camera(position=np.array([0.0, 1.0, 4.0], np.float32))
        cam.rotation = m3.mat3_to_quat(m3.mat4_inverse(m3.look_at(cam.position, [0, 1.0, 0]))[:3, :3])
        uniforms = camera.make_uniforms(cam, 128, 96)
        with numpy_joint_update():
            pal = procgen.wave_joint_palette(0.8, 8, amp=0.6)
        sides.append((scene, [(model, m3.Similarity())], uniforms, pal))
    config = RenderConfig(width=128, height=96, t_cap=16, t_cap_anim=512)
    (scene_r, inst_r, uni_r, pal_r), (scene_p, inst_p, uni_p, pal_p) = sides
    ref_state = ref_build(scene_r, inst_r, uni_r, joint_palettes={0: pal_r})
    port_state = port_build(scene_p, inst_p, uni_p, joint_palettes={0: pal_p}, device="cpu")
    return _geometry(scene_r.device_arrays(), scene_to_torch(scene_p, "cpu"),
                     ref_state, port_state, config, jit=jit)


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
    """A draw list made with each package's make_draw_list, through each
    package's geometry_pass (the vertex stage and the view setup):
    bit-exact against the eager reference (tests/test_raster_pallas.py's
    box at 96x256)."""
    import jax.numpy as jnp

    from superconductor_tpu.assets.models import load_model
    from superconductor_tpu.ops import geometry as ref_geom
    from superconductor_tpu_torch.assets.models import load_model as port_load_model
    from superconductor_tpu_torch.ops import geometry as port_geom

    scene = Scene()
    model = load_model(scene, box_glb, name="box")
    scene_p = PortScene()
    port_load_model(scene_p, box_glb, name="box")
    uniforms = ref_camera.make_uniforms(
        ref_camera.Camera(position=np.array([0.6, 0.8, 2.0], np.float32)), 256, 96)
    sim = _turned(ref_math3d, 0.6)
    prim, lod = model.primitives[0], model.primitives[0].lods[0]
    args = (sim.to_array()[None], np.array([lod.first_index // 3]),
            np.array([lod.index_count // 3]))
    kw = dict(first_vertex=np.array([lod.first_vertex]),
              vertex_count=np.array([lod.vertex_count]), material=np.array([prim.material]))
    dev = scene.device_arrays()
    dev_t = scene_to_torch(scene_p, "cpu")
    keys = ("indices", "positions", "normals", "uvs", "lightmap_uvs", "tri_material", "materials")
    tri_r, attrs_r = ref_geom.geometry_pass(
        ref_geom.make_draw_list(*args, **kw), *[dev[k] for k in keys],
        jnp.asarray(uniforms.view_proj[0]), 256, 96, t_cap=16,
    )
    tri_p, attrs_p = port_geom.geometry_pass(
        port_geom.make_draw_list(*args, **kw, device="cpu"), *[dev_t[k] for k in keys],
        torch.from_numpy(uniforms.view_proj[0]), 256, 96, t_cap=16,
    )
    for f in tri_r._fields:
        a, b = np.asarray(getattr(tri_r, f)), getattr(tri_p, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), f
    assert np.array_equal(np.asarray(attrs_r.packed), attrs_p.packed.numpy())
    assert np.asarray(tri_r.valid).sum() == 6

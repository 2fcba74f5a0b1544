"""The port's native frame-state code (native/src/framestate.cpp, a
byte-for-byte copy of the reference's, in the port's own library) against
the port's numpy walk and against the reference's native draw build.

* Draws: on the cases of the reference's tests/test_native_draws.py, the
  port's native build_frame_state equals its numpy walk
  (SC_TPU_NO_NATIVE_DRAWS) and the reference's default (native) build on
  every DrawList column and the joint palette, bit for bit.
* Animation: the FK walk (sc_joint_update), the batched palettes and the
  channel sampler (sc_anim_sample) equal the reference's default results
  bit for bit, with neither package forced onto numpy; malformed channels
  never reach the C sampler.
* Both libraries live in one process (the tests pin the reference's,
  test_torch_host.pin_reference_native): each package's functions resolve
  into its own file.
"""

import os

import numpy as np
import pytest
import torch

import superconductor_tpu.animation as ref_animation
import superconductor_tpu.native as ref_native
from conftest import make_box_glb
from superconductor_tpu.assets.models import load_model as ref_load_model
from superconductor_tpu.math3d import Similarity as RefSimilarity
from superconductor_tpu.nodes import ChildLink as RefChildLink
from superconductor_tpu.nodes import DepthFirstNodes as RefDepthFirstNodes
from superconductor_tpu.render import camera as ref_camera
from superconductor_tpu.render.culling import sphere_culling_params as ref_cull
from superconductor_tpu.render.draws import build_frame_state as ref_build
from superconductor_tpu.scene.scene import Scene as RefScene
from superconductor_tpu.utils import procgen as ref_procgen
from superconductor_tpu_torch import animation as port_animation
from superconductor_tpu_torch import native as port_native
from superconductor_tpu_torch.assets.models import load_model as port_load_model
from superconductor_tpu_torch.math3d import Similarity
from superconductor_tpu_torch.native import framestate as port_framestate
from superconductor_tpu_torch.nodes import ChildLink, DepthFirstNodes
from superconductor_tpu_torch.render import camera as port_camera
from superconductor_tpu_torch.render import draws as port_draws
from superconductor_tpu_torch.render.culling import sphere_culling_params as port_cull
from superconductor_tpu_torch.scene.scene import Scene
from superconductor_tpu_torch.utils import procgen as port_procgen
from test_lod import make_lod_glb
from test_torch_host import REF_HOST  # noqa: F401  (pins the reference's native library)

torch.set_num_threads(2)

PORT = dict(Scene=Scene, Similarity=Similarity, load_model=port_load_model,
            procgen=port_procgen, camera=port_camera, cull=port_cull)
REF = dict(Scene=RefScene, Similarity=RefSimilarity, load_model=ref_load_model,
           procgen=ref_procgen, camera=ref_camera, cull=ref_cull)
COLUMNS = ("sim8", "first_tri", "tri_count", "first_vertex", "vertex_count",
           "joints_offset", "material", "lightmapped", "valid")


def _rand_quat(rng):
    q = rng.normal(size=4).astype(np.float32)
    return q / np.linalg.norm(q)


def _case(name, h):
    """One case of the reference's tests/test_native_draws.py, built with
    the host modules `h` (PORT or REF) -> (scene, instances, uniforms,
    build_frame_state keywords)."""
    scene = h["Scene"]()
    sim = h["Similarity"]
    if name == "basic":
        sphere = h["procgen"].add_pbr_sphere(scene, stacks=6, slices=6)
        box = h["load_model"](scene, make_box_glb(), name="box")
        tube = h["procgen"].add_skinned_tube(scene, segments=4, slices=6, name="tube")
        rng = np.random.default_rng(7)
        models = [sphere, box, tube]
        instances = [
            (models[i % 3], sim(translation=rng.uniform(-20, 20, 3).astype(np.float32),
                                scale=float(rng.uniform(0.2, 3.0)), rotation=_rand_quat(rng)))
            for i in range(40)
        ]
        uniforms = h["camera"].make_uniforms(
            h["camera"].Camera(position=np.array([0, 0, 10.0], np.float32)), 640, 480)
        palettes = {
            i: np.tile(np.array([0, 0, 0, 1, 0, 0, 0, 1], np.float32), (5, 1)) * (1 + 0.01 * i)
            for i, (m, _s) in enumerate(instances) if m is tube
        }
        vp = np.asarray(uniforms.projection[0]) @ np.asarray(uniforms.view[0])
        return scene, instances, uniforms, dict(joint_palettes=palettes,
                                                cull_params=[h["cull"](vp)])
    if name == "lod":
        lod_model = h["load_model"](scene, make_lod_glb(), name="lod")
        sphere = h["procgen"].add_pbr_sphere(scene, stacks=4, slices=4)
        rng = np.random.default_rng(3)
        instances = [
            (lod_model if i % 2 else sphere,
             sim(translation=[0, 0, -float(rng.uniform(0.5, 400.0))],
                 scale=float(rng.uniform(0.5, 2.0))))
            for i in range(30)
        ]
        instances.append((lod_model, sim(translation=[0, 0, 0.0], scale=2.0)))
        uniforms = h["camera"].make_uniforms(
            h["camera"].Camera(position=np.array([0, 0, 2.0], np.float32)), 640, 480)
        return scene, instances, uniforms, {}
    sphere = h["procgen"].add_pbr_sphere(scene, stacks=4, slices=4)
    uniforms = h["camera"].make_uniforms(
        h["camera"].Camera(position=np.array([0, 0, 5.0], np.float32)), 64, 64)
    vp = np.asarray(uniforms.projection[0]) @ np.asarray(uniforms.view[0])
    return scene, [(sphere, sim(translation=[0, 0, 500.0]))], uniforms, dict(
        cull_params=[h["cull"](vp)])


def _columns(state):
    out = {}
    for which in ("draws_static", "draws_animated"):
        d = getattr(state, which)
        for f in COLUMNS:
            v = getattr(d, f)
            out[which + "." + f] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    jp = state.joint_palette
    out["joint_palette"] = jp.numpy() if isinstance(jp, torch.Tensor) else np.asarray(jp)
    return out


def _assert_columns_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, (k, a[k].dtype, b[k].dtype)
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("name", ["basic", "lod", "all-culled"])
def test_native_draws_match_numpy_and_reference(name, monkeypatch):
    """Every DrawList column and the palette: the port's native build
    equals its numpy walk and the reference's default (native) build."""
    assert port_draws._framestate_native()
    scene, instances, uniforms, kw = _case(name, PORT)
    native = _columns(port_draws.build_frame_state(scene, instances, uniforms, device="cpu", **kw))
    monkeypatch.setenv("SC_TPU_NO_NATIVE_DRAWS", "1")
    numpy_walk = _columns(port_draws.build_frame_state(scene, instances, uniforms, device="cpu",
                                                       **kw))
    monkeypatch.delenv("SC_TPU_NO_NATIVE_DRAWS")
    _assert_columns_equal(native, numpy_walk)
    r_scene, r_instances, r_uniforms, r_kw = _case(name, REF)
    _assert_columns_equal(_columns(ref_build(r_scene, r_instances, r_uniforms, **r_kw)), native)
    valid = native["draws_static.valid"]
    if name == "all-culled":
        assert not valid.any()
    else:
        assert valid.any()
    if name == "lod":  # the distance spread selects both LOD levels
        assert {1, 2} <= set(native["draws_static.tri_count"][valid].tolist())


def test_native_draws_scratch_is_copied():
    """build_draws_native(copy=False) returns views of one shared scratch
    pool that the next call overwrites: a FrameState built before another
    keeps its draws."""
    scene, instances, uniforms, kw = _case("basic", PORT)
    first = port_draws.build_frame_state(scene, instances, uniforms, device="cpu", **kw)
    kept = _columns(first)
    moved = [(m, Similarity(translation=s.translation + 1.0, scale=s.scale, rotation=s.rotation))
             for m, s in instances[::-1]]
    second = port_draws.build_frame_state(scene, moved, uniforms, device="cpu", **kw)
    assert not np.array_equal(_columns(second)["draws_static.sim8"], kept["draws_static.sim8"])
    _assert_columns_equal(_columns(first), kept)


def _tree(rng, n, link, sim):
    roots = [0, 1]
    children = [link(index=i, parent=int(rng.integers(0, i))) for i in range(2, n)]
    locals_ = []
    for _ in range(n):
        locals_.append(sim(translation=rng.normal(size=3).astype(np.float32),
                           scale=float(rng.uniform(0.5, 2.0)), rotation=_rand_quat(rng)))
    return roots, children, locals_


def test_native_joint_update_matches_reference():
    """sc_joint_update on a random 40-node, two-root tree: the globals and
    the joint palette equal the reference's default (native) walk bit for
    bit, and the port really took the native walk."""
    out = []
    for mod, link, dfn, sim in ((ref_animation, RefChildLink, RefDepthFirstNodes, RefSimilarity),
                                (port_animation, ChildLink, DepthFirstNodes, Similarity)):
        roots, children, locals_ = _tree(np.random.default_rng(11), 40, link, sim)
        df = dfn(roots=roots, children=children)
        aj = mod.AnimationJoints(locals_)
        aj.update(df)
        ib = np.random.default_rng(12).normal(size=(40, 8)).astype(np.float32)
        pal = aj.joint_palette(np.arange(40), ib, df)
        out.append((aj.global_translation, aj.global_scale, aj.global_rotation, pal))
    assert port_animation._joint_update_fn not in (None, False)
    for a, b in zip(*out):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_joint_palettes_batch_matches_reference():
    """joint_palettes_batch (the batched native FK) bit for bit against the
    reference's, on five instances of a 12-joint chain."""
    rng = np.random.default_rng(4)
    n, inst = 12, 5
    lt = rng.normal(size=(inst, n, 3)).astype(np.float32)
    ls = rng.uniform(0.5, 2.0, size=(inst, n)).astype(np.float32)
    lr = rng.normal(size=(inst, n, 4)).astype(np.float32)
    lr /= np.linalg.norm(lr, axis=-1, keepdims=True)
    ib = rng.normal(size=(n, 8)).astype(np.float32)
    args = (lt, ls, lr, np.zeros(1, np.int32), np.arange(n - 1, dtype=np.int32),
            np.arange(1, n, dtype=np.int32), np.arange(n), ib)
    ref = ref_animation.joint_palettes_batch(*args)
    port = port_animation.joint_palettes_batch(*args)
    assert ref is not None and port is not None and port.shape == (inst, n, 8)
    assert np.array_equal(ref.view(np.uint8), port.view(np.uint8))


def _channels(mod, sim_cls):
    """STEP / LINEAR / CUBIC_SPLINE translation and rotation channels and
    LINEAR scale channels on 20 joints (the reference's
    test_native_animate_matches_python), in module `mod`'s classes."""
    rng = np.random.default_rng(0)
    j, k = 20, 16
    times = np.linspace(0.0, 2.0, k).astype(np.float32)
    anim = mod.Animation(total_time=2.0)
    for i in range(j):
        interp = [mod.STEP, mod.LINEAR, mod.CUBIC_SPLINE][i % 3]
        n = 3 * k if interp == mod.CUBIC_SPLINE else k
        anim.translation_channels.append(mod.Channel(
            interpolation=interp, inputs=times,
            outputs=rng.normal(size=(n, 3)).astype(np.float32), node_index=i))
        q = rng.normal(size=(n, 4)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        anim.rotation_channels.append(mod.Channel(
            interpolation=interp, inputs=times, outputs=q, node_index=i))
        anim.scale_channels.append(mod.Channel(
            interpolation=mod.LINEAR, inputs=times,
            outputs=rng.uniform(0.5, 2, (k, 3)).astype(np.float32), node_index=i))
    return anim, j


def test_native_animate_matches_reference():
    """sc_anim_sample: every sampled local, bit for bit against the
    reference's default (native) sampling, inside, on and outside the key
    range; the port took the native sampler."""
    ref_anim, j = _channels(ref_animation, RefSimilarity)
    port_anim, _ = _channels(port_animation, Similarity)
    for t in [0.0, 0.5, 1.23456, 1.999, 2.0, 2.5, -0.1]:
        r = ref_animation.AnimationJoints([RefSimilarity() for _ in range(j)])
        p = port_animation.AnimationJoints([Similarity() for _ in range(j)])
        ref_anim.animate(r, t)
        port_anim.animate(p, t)
        for f in ("local_translation", "local_scale", "local_rotation"):
            a, b = getattr(r, f), getattr(p, f)
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (t, f)
    assert port_animation._anim_sample_fn not in (None, False)


def test_native_animate_rejects_malformed_channels():
    """Malformed channel meta never reaches the raw-pointer C sampler: an
    out-of-range node raises IndexError, a wrong component count or
    outputs shorter than the keys make _packed_channels None and the numpy
    path raises its clean error -- as in the reference."""
    mod = port_animation
    times = np.linspace(0.0, 1.0, 4).astype(np.float32)
    anim = mod.Animation(total_time=1.0)
    anim.translation_channels.append(mod.Channel(
        interpolation=mod.LINEAR, inputs=times, outputs=np.zeros((4, 3), np.float32),
        node_index=100000))
    with pytest.raises(IndexError):
        anim.animate(mod.AnimationJoints([Similarity() for _ in range(5)]), 0.5)
    anim2 = mod.Animation(total_time=1.0)
    anim2.translation_channels.append(mod.Channel(
        interpolation=mod.LINEAR, inputs=times, outputs=np.zeros((4, 16), np.float32),
        node_index=0))
    assert anim2._packed_channels() is None
    with pytest.raises(ValueError):
        anim2.animate(mod.AnimationJoints([Similarity()]), 0.5)
    anim3 = mod.Animation(total_time=1.0)
    anim3.translation_channels.append(mod.Channel(
        interpolation=mod.LINEAR, inputs=times, outputs=np.zeros((2, 3), np.float32),
        node_index=0))
    assert anim3._packed_channels() is None


@pytest.mark.parametrize("force_numpy", [False, True])
def test_single_keyframe_channel_holds_value(force_numpy, monkeypatch):
    """A one-key LINEAR channel sampled at its key time holds the key's
    value on both paths."""
    mod = port_animation
    anim = mod.Animation(total_time=0.0)
    anim.translation_channels.append(mod.Channel(
        interpolation=mod.LINEAR, inputs=np.zeros(1, np.float32),
        outputs=np.array([[1.5, 2.5, -3.0]], np.float32), node_index=0))
    if force_numpy:
        monkeypatch.setattr(mod, "_anim_sample_fn", False)
    joints = mod.AnimationJoints([Similarity()])
    anim.animate(joints, 0.0)
    assert np.array_equal(joints.local_translation[0], np.float32([1.5, 2.5, -3.0]))


def _mapped_file(address: int) -> str:
    """The file /proc/self/maps maps `address` from."""
    with open("/proc/self/maps") as f:
        for line in f:
            parts = line.split()
            lo, hi = (int(x, 16) for x in parts[0].split("-"))
            if lo <= address < hi and len(parts) >= 6:
                return os.path.realpath(parts[5])
    raise LookupError(hex(address))


def test_each_package_resolves_into_its_own_library():
    """The reference's library (pinned by test_torch_host) and the port's
    are both loaded and export the same C symbols; ctypes loads each with
    RTLD_LOCAL, so the port's draws, FK and sampler resolve into
    build/libscnative.so and the reference's into its own file."""
    import ctypes

    assert port_framestate.available() and ref_native.load_native() is not None
    port_lib, ref_lib = port_native.load_native(), ref_native.load_native()
    assert os.path.realpath(port_lib._name) != os.path.realpath(ref_lib._name)
    for symbol in ("sc_build_draws", "sc_joint_update", "sc_anim_sample"):
        for lib in (port_lib, ref_lib):
            address = ctypes.cast(getattr(lib, symbol), ctypes.c_void_p).value
            assert _mapped_file(address) == os.path.realpath(lib._name), (symbol, lib._name)
    assert port_animation._get_joint_update_fn() is not False
    address = ctypes.cast(port_animation._get_joint_update_fn(), ctypes.c_void_p).value
    assert _mapped_file(address) == os.path.realpath(port_native.LIB_PATH)

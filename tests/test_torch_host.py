"""The port's host layer against the reference's: no import of the
reference package, and bit-for-bit parity of asset loading, procedural
content, camera uniforms, culling and host math on the same inputs.

``REF_HOST`` is the reference's host layer under the names
``superconductor_tpu_torch.scenes`` builds its scenes with; the other
parity tests build the reference side of a scene with it."""

import contextlib
import ctypes
import fcntl
import glob
import os
import re
import shlex
import shutil
import subprocess
import sys
import tempfile
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "superconductor_tpu_torch")
REF_NATIVE = os.path.join(REPO, "superconductor_tpu", "native")


def _build_atomically(cmd_out, dst: str) -> None:
    """Run cmd_out(tmp) to write a file into a temporary path beside dst,
    then rename it over dst: a reader sees the old file or the whole new
    one, never a part."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(dst))
    os.close(fd)
    try:
        cmd_out(tmp)
        os.replace(tmp, dst)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def pin_reference_native() -> None:
    """Give the reference's native loader, in this process, a library that
    nobody writes in place.

    The reference's loader runs `make` when its library is missing, and
    make's g++ writes superconductor_tpu/native/libscnative.so in place.
    Test workers reach that loader together while collecting (a JAX-package
    test module calls it at import, before any port module is collected):
    one opens the file while another's g++ is still writing it ("file too
    short"), and the loader remembers the failure for the process's life --
    the hero's ETC1S textures then stay on their dummy texels. So, under a
    lock, this builds the library once into build/reference_native/ (g++
    with the Makefile's command and flags, into a temporary file renamed
    into place) and hands that file to the loader, replacing whatever it
    holds; every port test module imports this one. The in-place library
    is refreshed from the same build, by rename, for processes that load
    it themselves."""
    import superconductor_tpu.native as ref_native

    sources = sorted(glob.glob(os.path.join(REF_NATIVE, "src", "*.cpp")))
    deps = sources + glob.glob(os.path.join(REF_NATIVE, "src", "*.h"))
    private = os.path.join(REPO, "build", "reference_native", "libscnative.so")
    in_place = os.path.join(REF_NATIVE, "libscnative.so")

    def fresh(lib):
        return os.path.exists(lib) and all(
            os.path.getmtime(lib) >= os.path.getmtime(f) for f in deps
        )

    def compile_to(out):
        # the Makefile's rule: $(CXX) $(CXXFLAGS) $(SRCS) -o $@
        cxx = os.environ.get("CXX", "g++")
        flags = shlex.split(os.environ.get("CXXFLAGS", "-O2 -fPIC -shared -std=c++17 -Wall"))
        subprocess.run([cxx, *flags, *sources, "-o", out], check=True,
                       capture_output=True, timeout=600)

    os.makedirs(os.path.dirname(private), exist_ok=True)
    with open(os.path.join(REPO, "build", "reference_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not fresh(private):
            _build_atomically(compile_to, private)
        if not fresh(in_place):
            _build_atomically(lambda out: shutil.copyfile(private, out), in_place)
    ref_native._lib = ctypes.CDLL(private)
    ref_native._lib_tried = True


pin_reference_native()

import superconductor_tpu.animation as ref_animation
import superconductor_tpu.math3d as ref_math3d
from superconductor_tpu.assets.models import load_model as ref_load_model
from superconductor_tpu.render import camera as ref_camera
from superconductor_tpu.render import culling as ref_culling
from superconductor_tpu.render import lod as ref_lod
from superconductor_tpu.render.env import EnvBindings as RefEnvBindings
from superconductor_tpu.scene import scene as ref_scene
from superconductor_tpu.utils import procgen as ref_procgen
from superconductor_tpu_torch import math3d as port_math3d
from superconductor_tpu_torch.assets.models import load_model as port_load_model
from superconductor_tpu_torch.render import camera as port_camera
from superconductor_tpu_torch.render import culling as port_culling
from superconductor_tpu_torch.render import lod as port_lod
from superconductor_tpu_torch.render.env import EnvBindings as PortEnvBindings
from superconductor_tpu_torch.scene import scene as port_scene
from superconductor_tpu_torch.scenes import HERO_GLB, HOST
from superconductor_tpu_torch.utils import procgen as port_procgen

# The test workers share the CPU: torch's default of a thread per core in
# each of them oversubscribes it many times over.
torch.set_num_threads(2)
# torch computes log2, exp and the like on CPU tensors with oneMKL's vector
# math, which sets itself up on its first call. When that first call is
# split over torch's two threads, in a process that has loaded jax and on a
# busy host, the second thread's half can come from oneMKL's AVX2
# low-accuracy (VML_EP) kernel instead of the AVX-512 high-accuracy one:
# log2 up to 2.4e-5 off, on that call only. Make the first calls here, on
# one thread and then on both, before any test compares a result.
torch.log2(torch.ones(16))
torch.log2(torch.ones(1 << 14))

REF_HOST = SimpleNamespace(
    Scene=ref_scene.Scene, load_model=ref_load_model,
    gradient_cubemap=ref_procgen.gradient_cubemap,
    add_pbr_sphere=ref_procgen.add_pbr_sphere,
    checker_texture=ref_procgen.checker_texture,
    default_ambient_sh=ref_procgen.default_ambient_sh,
    build_mip_chain=ref_scene.build_mip_chain, Camera=ref_camera.Camera,
    make_uniforms=ref_camera.make_uniforms, EnvBindings=RefEnvBindings,
    math3d=ref_math3d, add_skinned_tube=ref_procgen.add_skinned_tube,
    wave_joint_palettes=ref_procgen.wave_joint_palettes,
    make_stereo_uniforms=ref_camera.make_stereo_uniforms,
)


JOINT_PATHS = ("native", "numpy")


@contextlib.contextmanager
def joint_path(mode: str):
    """Run both packages' joint-palette code on one path: "native" (the FK
    walk sc_joint_update of framestate.cpp, each package's default) or
    "numpy" (each animation module's _joint_update_fn set to False, the
    reference's own switch). The two paths round an ulp apart, so a
    comparison of the packages runs one path on both sides."""
    import superconductor_tpu_torch.animation as port_animation

    mods = (ref_animation, port_animation)
    saved = [m._joint_update_fn for m in mods]
    if mode == "numpy":
        for m in mods:
            m._joint_update_fn = False
    elif mode != "native":
        raise ValueError(mode)
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m._joint_update_fn = fn


def numpy_joint_update():
    """Both packages' joint palettes on the numpy FK (joint_path("numpy"))."""
    return joint_path("numpy")


def test_ref_host_has_the_port_host_names():
    assert sorted(vars(REF_HOST)) == sorted(vars(HOST))


def assert_same(ref, port, path="", seen=None):
    """Recursive bit-for-bit equality of a reference object graph and the
    port's: arrays by dtype, shape and bytes; objects by every attribute the
    port keeps (the reference's device caches have no port counterpart);
    containers element by element; anything else by ==."""
    seen = set() if seen is None else seen
    if id(port) in seen:
        return
    if isinstance(port, np.ndarray):
        assert isinstance(ref, np.ndarray), path
        assert ref.dtype == port.dtype and ref.shape == port.shape, path
        assert np.array_equal(np.ascontiguousarray(ref).view(np.uint8),
                              np.ascontiguousarray(port).view(np.uint8)), path
    elif isinstance(port, dict):
        assert sorted(map(str, ref)) == sorted(map(str, port)), path
        for k in port:
            assert_same(ref[k], port[k], f"{path}[{k!r}]", seen)
    elif isinstance(port, (list, tuple)):
        assert len(ref) == len(port), path
        for i, (a, b) in enumerate(zip(ref, port)):
            assert_same(a, b, f"{path}[{i}]", seen)
    elif isinstance(port, (set, frozenset)):
        assert ref == port, path
    elif hasattr(port, "__dict__") or hasattr(port, "__slots__"):
        assert type(ref).__name__ == type(port).__name__, path
        seen.add(id(port))
        names = set(getattr(port, "__dict__", {})) | set(getattr(port, "__slots__", ()))
        for name in sorted(names):
            if name == "_frame_arrays":  # the draw build's lazy cache
                continue
            assert hasattr(ref, name), f"{path}.{name}"
            assert_same(getattr(ref, name), getattr(port, name), f"{path}.{name}", seen)
    elif isinstance(port, float) and np.isnan(port):
        assert np.isnan(ref), path
    else:
        assert ref == port and type(ref) is type(port), (path, ref, port)


# --- no import of the reference ------------------------------------------

_BLOCKED_CHILD = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "superconductor_tpu"):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Blocker())
    import superconductor_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    from superconductor_tpu_torch.render.caps import fit_caps
    from superconductor_tpu_torch.render.frame import render_frame
    from superconductor_tpu_torch.scenes import headline_scene

    dev, build, config, env = headline_scene(64, 32, "cpu")
    state = build(0.3)
    config = fit_caps(dev, state, config, env)
    img = render_frame(dev, state, config, env)
    assert tuple(img.shape) == (1, 32, 64, 4) and int(img.float().std()) > 0
    assert "jax" not in sys.modules and "superconductor_tpu" not in sys.modules
    print("modules", len(names))
    """
)


def test_port_runs_with_reference_and_jax_blocked():
    """Every module of the port imports, and the headline frame renders
    through fit_caps and render_frame, in a process where importing jax or
    superconductor_tpu raises."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_CHILD], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split("modules")[-1]) >= 30


_IMPORT_OF_REFERENCE = re.compile(r"^\s*(from|import)\s+superconductor_tpu(\.|\s|$)", re.M)


def test_no_import_statement_of_the_reference():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    for path in files:
        with open(path) as f:
            assert not _IMPORT_OF_REFERENCE.search(f.read()), path


# --- assets and procedural content ---------------------------------------

def _glb(which, box_glb):
    if which == "box":
        return box_glb
    with open(HERO_GLB, "rb") as f:
        return f.read()


@pytest.mark.parametrize("which", ["hero", "box"])
def test_load_model_matches_reference(which, box_glb):
    """hero_helmet.glb (meshopt, MSFT_lod, KHR_texture_basisu) and the box
    fixture: the returned Model and every Scene table -- vertex and index
    mega-buffers, texel pools and their descriptors, neighbour tables,
    materials, models, LOD ranges -- equal bit for bit."""
    glb = _glb(which, box_glb)
    ref, port = ref_scene.Scene(), port_scene.Scene()
    model_r = ref_load_model(ref, glb, name="m")
    model_p = port_load_model(port, glb, name="m")
    assert_same(model_r, model_p, "model")
    assert_same(ref, port, "scene")
    assert_same(ref.material_arrays(), port.material_arrays(), "materials")
    for pool in ("textures", "textures_hdr"):
        assert_same(getattr(ref, pool).descriptor_arrays(),
                    getattr(port, pool).descriptor_arrays(), pool)
    assert_same(ref.matq_plan(), port.matq_plan(), "matq_plan")
    assert ref.texture_memory_report() == port.texture_memory_report()
    if which == "hero":
        assert max(len(p.lods) for p in model_p.primitives) > 1
        assert port.textures.num_textures > 3


def test_assert_same_sees_one_changed_value(box_glb):
    """The comparison above is not vacuous: one texel byte, one LOD range
    or one material factor changed in the port's scene is found."""
    def scenes():
        ref, port = ref_scene.Scene(), port_scene.Scene()
        ref_load_model(ref, box_glb, name="m")
        port_load_model(port, box_glb, name="m")
        return ref, port

    for change in (
        lambda s: s.textures.texels.host.__setitem__((5, 1), s.textures.texels.host[5, 1] ^ 1),
        lambda s: setattr(s.models["m"].primitives[0].lods[0], "index_count", 3),
        lambda s: setattr(s.materials[0], "roughness_factor", 0.25),
    ):
        ref, port = scenes()
        assert_same(ref, port)
        change(port)
        with pytest.raises(AssertionError):
            assert_same(ref, port)


def test_procgen_matches_reference():
    """checker_texture, default_ambient_sh, gradient_cubemap and
    add_pbr_sphere, and the scenes they build, bit for bit."""
    assert_same(ref_procgen.checker_texture(), port_procgen.checker_texture())
    assert_same(ref_procgen.default_ambient_sh(), port_procgen.default_ambient_sh())
    ref, port = ref_scene.Scene(), port_scene.Scene()
    assert ref_procgen.gradient_cubemap(ref) == port_procgen.gradient_cubemap(port)
    for stacks in (8, 33):
        assert_same(ref_procgen.add_pbr_sphere(ref, stacks=stacks, slices=stacks),
                    port_procgen.add_pbr_sphere(port, stacks=stacks, slices=stacks))
    assert_same(ref, port, "scene")
    assert_same(ref.material_arrays(), port.material_arrays())
    assert_same(RefEnvBindings.from_scene(ref), PortEnvBindings.from_scene(port))


@pytest.mark.parametrize("mode", JOINT_PATHS)
def test_skinned_content_matches_reference_numpy_path(mode):
    """add_skinned_tube and the waving joint palettes bit for bit, with the
    FK on one path on both sides: the native walk (each package's default)
    or the numpy one. The two paths differ by an ulp somewhere."""
    ref, port = ref_scene.Scene(), port_scene.Scene()
    assert_same(ref_procgen.add_skinned_tube(ref, segments=6, slices=5),
                port_procgen.add_skinned_tube(port, segments=6, slices=5))
    assert_same(ref, port, "scene")
    ts = np.linspace(0.0, 3.0, 7, dtype=np.float32)
    with joint_path(mode):
        pal = port_procgen.wave_joint_palettes(ts, 8, amp=0.6)
        assert_same(ref_procgen.wave_joint_palettes(ts, 8, amp=0.6), pal)
    with joint_path("numpy" if mode == "native" else "native"):
        other = port_procgen.wave_joint_palettes(ts, 8, amp=0.6)
    assert not np.array_equal(pal, other)


@pytest.mark.parametrize("reverse_z", [True, False])
def test_make_uniforms_matches_reference(reverse_z):
    rng = np.random.default_rng(3)
    for _ in range(4):
        pos = rng.uniform(-3, 3, size=3).astype(np.float32)
        q = ref_math3d.quat_normalize(rng.normal(size=4).astype(np.float32))
        w, h = int(rng.integers(16, 2000)), int(rng.integers(16, 1200))
        kw = dict(fov_y=float(rng.uniform(0.5, 1.5)), z_near=float(rng.uniform(0.01, 0.5)),
                  reverse_z=reverse_z)
        ur = ref_camera.make_uniforms(ref_camera.Camera(pos, q), w, h, **kw)
        up = port_camera.make_uniforms(port_camera.Camera(pos, q), w, h, **kw)
        assert_same(ur.as_device_dict(), up.as_device_dict())
        assert_same(ur, up)


@pytest.mark.parametrize("scene", ["headline", "clip_blend", "all_passes", "lit_passes"])
def test_scene_builders_match_with_either_host(scene):
    """scenes.headline_host / clip_blend_host / all_passes_host /
    lit_passes_host built with the reference's host layer and with the
    port's give equal scenes, uniforms, env and instances (the other parity
    tests rely on it)."""
    from superconductor_tpu_torch.scenes import (
        all_passes_host,
        clip_blend_host,
        headline_host,
        lit_passes_host,
    )

    if scene == "lit_passes":
        kw = dict(n_spheres=3, stacks=8, lightmap_size=16, smoke_size=16)
        ref = lit_passes_host(64, 32, **kw, host=REF_HOST)
        port = lit_passes_host(64, 32, **kw)
        assert_same(ref[1](0.4), port[1](0.4), "instances")
        assert_same(ref[5], port[5], "draw keywords")
    elif scene == "headline":
        ref = headline_host(64, 32, host=REF_HOST)
        port = headline_host(64, 32)
    elif scene == "all_passes":
        ref = all_passes_host(64, 32, n_spheres=3, stacks=8, host=REF_HOST)
        port = all_passes_host(64, 32, n_spheres=3, stacks=8)
        assert_same(ref[1](0.4), port[1](0.4), "instances")
        assert_same(ref[5], port[5], "draw keywords")
    else:
        ref = clip_blend_host(64, 32, n_spheres=3, stacks=8, host=REF_HOST)
        port = clip_blend_host(64, 32, n_spheres=3, stacks=8)
        assert_same(ref[1](0.4), port[1](0.4), "instances")
    assert_same(ref[0], port[0], "scene")
    assert_same(ref[2], port[2], "uniforms")
    assert_same(ref[3], port[3], "env")
    assert ref[4] == port[4]


# --- culling, LOD and math -----------------------------------------------

def _sims(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([rng.uniform(-4, 4, size=(n, 3)),
                           rng.uniform(0.2, 3, size=(n, 1)), q], axis=1).astype(np.float32)


def test_culling_matches_reference():
    rng = np.random.default_rng(17)
    n = 512
    cam = ref_camera.Camera(np.array([0.3, 0.5, 4.0], np.float32),
                            ref_math3d.quat_from_axis_angle([0, 1, 0], 0.2))
    vp = ref_camera.make_uniforms(cam, 640, 360).view_proj[0]
    for infinite_far in (True, False):
        pr = ref_culling.sphere_culling_params(vp, infinite_far)
        pp = port_culling.sphere_culling_params(vp, infinite_far)
        assert_same(pr, pp)
        centers = rng.uniform(-8, 8, size=(n, 3)).astype(np.float32)
        radii = rng.uniform(0, 2, size=n).astype(np.float32)
        vis = port_culling.test_bounding_spheres(centers, radii, pp)
        assert_same(ref_culling.test_bounding_spheres(centers, radii, pr), vis)
        assert 0 < vis.sum() < n
    bmin = rng.uniform(-1, 0, size=(n, 3)).astype(np.float32)
    bmax = bmin + rng.uniform(0.01, 2, size=(n, 3)).astype(np.float32)
    sim8 = _sims(rng, n)
    assert_same(ref_culling.test_obbs_sat(bmin, bmax, sim8, pr),
                port_culling.test_obbs_sat(bmin, bmax, sim8, pp))
    view = cam.view_matrix()
    fr = ref_culling.CullingFrustum.new(np.pi / 3, 16 / 9, 0.05, 50.0)
    fp = port_culling.CullingFrustum.new(np.pi / 3, 16 / 9, 0.05, 50.0)
    assert_same(fr, fp)
    vis = port_culling.test_obbs_sat_exact(bmin, bmax, sim8, view, fp)
    assert_same(ref_culling.test_obbs_sat_exact(bmin, bmax, sim8, view, fr), vis)
    assert 0 < vis.sum() < n


def test_lod_selection_matches_reference():
    with open(HERO_GLB, "rb") as f:
        glb = f.read()
    model_r = ref_load_model(ref_scene.Scene(), glb, name="m")
    model_p = port_load_model(port_scene.Scene(), glb, name="m")
    for dist in (0.5, 2.0, 8.0, 40.0, 200.0):
        sim_r = ref_math3d.Similarity(translation=[0.0, 0.0, -dist])
        sim_p = port_math3d.Similarity(translation=[0.0, 0.0, -dist])
        eye = np.zeros(3, np.float32)
        for pr, pp in zip(model_r.primitives, model_p.primitives):
            assert ref_lod.select_lod(pr, sim_r, eye) == port_lod.select_lod(pp, sim_p, eye)
        assert ref_lod.screen_coverage(sim_r.translation, 1.3, eye) == \
            port_lod.screen_coverage(sim_p.translation, 1.3, eye)


def test_math3d_matches_reference():
    """Every host function of math3d on seeded numpy inputs, bit for bit,
    and the torch path of quat_rotate / similarity_apply against the numpy
    path (same operand order, same rounding)."""
    rng = np.random.default_rng(23)
    n = 256
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q2 = rng.normal(size=(n, 4)).astype(np.float32)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    s8, s8b = _sims(rng, n), _sims(rng, n)
    for name, args in [
        ("quat_mul", (q, q2)), ("quat_conj", (q,)), ("quat_rotate", (q, v)),
        ("quat_normalize", (q,)), ("quat_to_mat3", (q,)),
        ("similarity_apply", (s8, v)), ("similarity_compose8", (s8, s8b)),
        ("quat_slerp", (ref_math3d.quat_normalize(q[0]), ref_math3d.quat_normalize(q2[0]), 0.3)),
        ("quat_from_axis_angle", (v[0], 0.7)),
        ("mat3_to_quat", (ref_math3d.quat_to_mat3(ref_math3d.quat_normalize(q[1])),)),
        ("look_at", (v[0], v[1])), ("view_from_camera", (v[2], ref_math3d.quat_normalize(q[2]))),
        ("perspective_reversed_z_infinite", (1.0, 1.7, 0.05)),
        ("perspective_z01", (1.0, 1.7, 0.05, 100.0)),
        ("mat4_inverse", (rng.normal(size=(4, 4)).astype(np.float32),)),
    ]:
        assert_same(getattr(ref_math3d, name)(*args), getattr(port_math3d, name)(*args), name)
    for i in range(4):
        a_r, a_p = (m.Similarity.from_array(s8[i]) for m in (ref_math3d, port_math3d))
        b_r, b_p = (m.Similarity.from_array(s8b[i]) for m in (ref_math3d, port_math3d))
        assert_same((a_r * b_r).to_array(), (a_p * b_p).to_array())
        assert_same(a_r.inverse().to_array(), a_p.inverse().to_array())
        assert_same(a_r.apply_point(v[i]), a_p.apply_point(v[i]))
        m4 = np.eye(4, dtype=np.float32)
        m4[:3, :3] = ref_math3d.quat_to_mat3(s8[i, 4:8]) * 1.5
        assert_same(ref_math3d.Similarity.from_mat4(m4).to_array(),
                    port_math3d.Similarity.from_mat4(m4).to_array())
    t_rot = port_math3d.quat_rotate(torch.from_numpy(q), torch.from_numpy(v)).numpy()
    assert_same(port_math3d.quat_rotate(q, v), t_rot)
    t_app = port_math3d.similarity_apply(torch.from_numpy(s8), torch.from_numpy(v)).numpy()
    assert_same(port_math3d.similarity_apply(s8, v), t_app)

"""The port's ECS app layer (superconductor_tpu_torch/ecs) on the CPU.

* The six cases of tests/test_ecs.py, through the port's App with
  raster="ref" at 64x64 and device="cpu"; the load-and-render case also
  with raster="auto" (the binned path, whose kernels run their plain
  versions on CPU tensors).
* Parity: one script -- the box and the skinned ribbon, four frames with
  the animation time stepped, debug lines (skeleton + bounding boxes) and
  the test particles -- through the reference's App
  (CorePlugin(config=RenderConfig(raster="ref"))) and the port's. The
  reference runs in a child process whose XLA CPU backend is capped at
  AVX (without FMA contraction its depths round op by op, as the port's
  do: the bounding-box lines lie on the ribbon's plane and would otherwise
  flip depth ties; tests/test_torch_raster.py), once with both packages'
  joint FK on the native walk (their default) and once on the numpy one
  (test_torch_host.joint_path). The settled RenderConfigs are
  equal field by field, the joint palettes bit for bit, and every frame is
  >= 40 dB from the reference's (the goldens bar, tests/test_goldens.py:48)
  with an equal stats dict.
* Growth past the k-buffer kernel's templates: 20 quads stacked along the
  view ray grow the blend, clip or particle pass to K = 32 through the
  port's App on the binned path and through the reference's, with equal
  configs, stats and frames.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_host import JOINT_PATHS, joint_path  # (also pins the reference's native library)
from superconductor_tpu.utils.metrics import psnr
from superconductor_tpu_torch.assets.fetch import MemoryClient
from superconductor_tpu_torch.ecs import debugging, systems
from superconductor_tpu_torch.ecs.app import App, Stage
from superconductor_tpu_torch.ecs.components import (
    AnimatedModelUrl,
    Instance,
    InstanceOf,
    JointsComponent,
    ModelComponent,
    ModelUrl,
)
from superconductor_tpu_torch.ecs.resources import (
    CameraResource,
    FrameOutput,
    LineBuffer,
    ParticleBuffer,
    RenderSettings,
)
from superconductor_tpu_torch.ecs.systems import CorePlugin
from superconductor_tpu_torch.math3d import Similarity
from superconductor_tpu_torch.render.frame import RenderConfig
from superconductor_tpu_torch.scenes import box_glb, skinned_ribbon_glb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_app(files, width=64, height=64, raster="ref", **cfg):
    app = App()
    app.add_plugin(CorePlugin(
        config=RenderConfig(width=width, height=height, t_cap=64, t_cap_anim=64,
                            raster=raster, **cfg),
        client=MemoryClient(files), device="cpu",
    ))
    return app


def _wait_loaded(app, entity, ctype=ModelComponent, frames=100):
    for _ in range(frames):
        app.update()
        if app.world.get(entity, ctype) is not None:
            return True
    return False


def _image(app) -> np.ndarray:
    img = app.world.resource(FrameOutput).image
    assert isinstance(img, torch.Tensor) and img.device.type == "cpu"
    return img.numpy()


# --- the six cases of tests/test_ecs.py ------------------------------------

@pytest.mark.parametrize("raster", ["ref", "auto"])
def test_ecs_loads_and_renders_model(raster):
    app = _make_app({"box.glb": box_glb()}, raster=raster)
    w = app.world
    w.resource(CameraResource).camera.position = np.array([0, 0, 2.5], np.float32)
    model_e = w.spawn(ModelUrl("box.glb"))
    w.spawn(Instance(Similarity()), InstanceOf(model_e))
    assert _wait_loaded(app, model_e)
    app.update()
    img = _image(app)[0]
    # unlit red box visible in the middle
    assert img[32, 32, 0] == 255
    # the tables stay resident: a frame with nothing changed uploads nothing
    assert w.resource(systems.SceneResource).device_scene.last_upload == {}


def test_ecs_animated_model_skins():
    app = _make_app({"ribbon.glb": skinned_ribbon_glb()})
    w = app.world
    w.resource(CameraResource).camera.position = np.array([0.0, 1.0, 4.0], np.float32)
    model_e = w.spawn(AnimatedModelUrl("ribbon.glb"))
    inst_e = w.spawn(Instance(Similarity()), InstanceOf(model_e))
    assert _wait_loaded(app, model_e)
    app.update()
    jc = w.get(inst_e, JointsComponent)
    assert jc is not None and jc.palette is not None
    assert jc.palette.shape == (2, 8)
    img0 = _image(app)[0].astype(int)

    # t = 1.0: 90 degrees of bend at the top joint sweeps the ribbon's top
    jc.time = 0.999
    app.update()
    img1 = _image(app)[0].astype(int)
    g0 = img0[..., 1] > 200
    g1 = img1[..., 1] > 200
    assert g0.sum() > 10 and g1.sum() > 10
    moved = np.logical_xor(g0, g1).sum() / max(g0.sum(), 1)
    assert moved > 0.3
    assert abs(w.get(inst_e, JointsComponent).palette[1, 6]) > 0.5  # sin(45 deg) about z


def test_ecs_bad_url_degrades():
    app = _make_app({"box.glb": box_glb()})
    w = app.world
    bad_e = w.spawn(ModelUrl("missing.glb"))
    ok_e = w.spawn(ModelUrl("box.glb"))
    w.spawn(Instance(Similarity()), InstanceOf(ok_e))
    assert _wait_loaded(app, ok_e)
    assert w.get(bad_e, ModelComponent) is None
    assert w.resource(FrameOutput).image is not None


def test_debug_line_systems():
    app = _make_app({"ribbon.glb": skinned_ribbon_glb(), "box.glb": box_glb()},
                    enable_lines=True)
    app.add_system(Stage.INSTANCE_BUFFERING, debugging.push_joints_to_lines)
    app.add_system(Stage.INSTANCE_BUFFERING, debugging.push_bounding_boxes_to_lines)
    w = app.world
    w.resource(CameraResource).camera.position = np.array([0, 1, 4], np.float32)
    skinned_e = w.spawn(AnimatedModelUrl("ribbon.glb"))
    box_e = w.spawn(ModelUrl("box.glb"))
    w.spawn(Instance(Similarity()), InstanceOf(skinned_e))
    w.spawn(Instance(Similarity(translation=[2, 0, 0])), InstanceOf(box_e))
    assert _wait_loaded(app, skinned_e)
    assert _wait_loaded(app, box_e)
    app.update()
    # skeleton: 2 bone links; bboxes: 12 edges per primitive x 2 models
    assert len(w.resource(LineBuffer).segments) == 2 + 12 * 2
    assert w.resource(FrameOutput).image is not None


def test_ecs_stereo_renders_two_eyes():
    app = _make_app({"box.glb": box_glb()}, num_views=2)
    w = app.world
    w.resource(CameraResource).camera.position = np.array([0, 0, 1.2], np.float32)
    w.resource(CameraResource).ipd = 0.3  # exaggerate parallax
    model_e = w.spawn(ModelUrl("box.glb"))
    w.spawn(Instance(Similarity()), InstanceOf(model_e))
    assert _wait_loaded(app, model_e)
    app.update()
    img = _image(app)
    assert img.shape[0] == 2
    left, right = img[0], img[1]
    assert (left[..., 0] == 255).any() and (right[..., 0] == 255).any()
    assert (left != right).mean() > 0.005


def test_ecs_zero_read_mode_matches_default():
    """stats_interval=0 renders with render_frame (no stats read) and gives
    the same image as stats_interval=1; pending_stats stays unset."""
    imgs = {}
    for interval in (1, 0):
        app = _make_app({"box.glb": box_glb()})
        w = app.world
        w.resource(RenderSettings).stats_interval = interval
        w.resource(CameraResource).camera.position = np.array([0, 0, 2.5], np.float32)
        model_e = w.spawn(ModelUrl("box.glb"))
        w.spawn(Instance(Similarity()), InstanceOf(model_e))
        assert _wait_loaded(app, model_e)
        app.update()
        out = w.resource(FrameOutput)
        if interval == 0:
            assert out.pending_stats is None
        imgs[interval] = _image(app)
    np.testing.assert_array_equal(imgs[0], imgs[1])


# --- the port's own rules ---------------------------------------------------

DEEP = dict(width=64, height=64, frames=2, n=20, seed=41)
PORT_APP = SimpleNamespace(
    App=App, Stage=Stage, CorePlugin=CorePlugin, MemoryClient=MemoryClient,
    RenderConfig=RenderConfig, Instance=Instance, InstanceOf=InstanceOf, ModelUrl=ModelUrl,
    ModelComponent=ModelComponent, ParticleBuffer=ParticleBuffer, Similarity=Similarity,
)

def deep_stack(ns, pass_name: str, raster: str, **plugin_kw):
    """An App over DEEP["n"] quads stacked along the view ray of the
    camera at the origin, at seeded depths, two of them at one depth: unit
    boxes seen face on
    (alpha-blended or alpha-clipped), or particles in front of an opaque
    box. `ns` names the App's classes (the port's or the reference's)."""
    rng = np.random.default_rng(DEEP["seed"])
    zs = np.sort(rng.uniform(-9.0, -2.5, size=DEEP["n"]))
    zs[7] = zs[6]
    mode = {"blend": "BLEND", "clip": "MASK", "particle": None}[pass_name]
    glb = box_glb(alpha_mode=mode, base_color=(1.0, 0.2, 0.1, 0.5))
    app = ns.App()
    app.add_plugin(ns.CorePlugin(
        config=ns.RenderConfig(width=DEEP["width"], height=DEEP["height"], t_cap=512,
                               t_cap_anim=64, raster=raster),
        client=ns.MemoryClient({"box.glb": glb}), **plugin_kw))
    w = app.world
    box_e = w.spawn(ns.ModelUrl("box.glb"))
    if pass_name == "particle":
        w.spawn(ns.Instance(ns.Similarity(translation=[0.0, 0.0, -12.0], scale=6.0)),
                ns.InstanceOf(box_e))

        def push(world):
            pb = world.get_resource(ns.ParticleBuffer)
            for z in zs:
                pb.push(center=[0.0, 0.0, float(z)], scale=[0.8, 0.8],
                        colour=[0.85, 0.85, 0.9], emissive_colour=[0.3, 0.2, 0.1])

        app.add_system(ns.Stage.INSTANCE_BUFFERING, push)
    else:
        for z in zs:
            w.spawn(ns.Instance(ns.Similarity(translation=[0.0, 0.0, float(z)])),
                    ns.InstanceOf(box_e))
    deadline = time.time() + 120
    while w.get(box_e, ns.ModelComponent) is None:
        assert time.time() < deadline, "the model did not load"
        for fn in app._systems[ns.Stage.ASSET_LOADING]:
            fn(w)
        time.sleep(0.01)
    return app


_DEEP_CHILD = textwrap.dedent(
    """
    import dataclasses, json, sys
    from types import SimpleNamespace
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, "tests")
    from test_torch_ecs import DEEP, deep_stack
    from superconductor_tpu.assets.fetch import MemoryClient
    from superconductor_tpu.ecs.app import App, Stage
    from superconductor_tpu.ecs.components import Instance, InstanceOf, ModelComponent, ModelUrl
    from superconductor_tpu.ecs.resources import FrameOutput, ParticleBuffer, RenderSettings
    from superconductor_tpu.ecs.systems import CorePlugin
    from superconductor_tpu.math3d import Similarity
    from superconductor_tpu.render.frame import RenderConfig, stats_to_host

    ns = SimpleNamespace(**{k: v for k, v in globals().items() if k[0].isupper()})
    app = deep_stack(ns, sys.argv[2], "pallas")
    images, stats, configs = [], [], []
    for _ in range(DEEP["frames"]):
        app.update()
        fo = app.world.resource(FrameOutput)
        images.append(np.asarray(fo.image))
        stats.append(stats_to_host(fo.pending_stats[0]))
        configs.append(dataclasses.asdict(app.world.resource(RenderSettings).config))
    np.savez(sys.argv[1], images=np.stack(images),
             meta=json.dumps({"stats": stats, "configs": configs}))
    """
)


@pytest.fixture(scope="module")
def deep_reference():
    """The three deep stacks through the reference's App (raster="pallas":
    its interpret-mode k-buffer kernel), one child process a pass, run
    together; each child's XLA CPU backend is capped at AVX, so its depths
    round op by op as the port's do (tests/test_torch_kbuffer.py)."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
        env.pop("PYTHONPATH", None)
        children = {
            name: subprocess.Popen(
                [sys.executable, "-c", _DEEP_CHILD, os.path.join(tmp, f"{name}.npz"), name],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for name in ("blend", "clip", "particle")
        }
        out = {}
        for name, child in children.items():
            log, _ = child.communicate(timeout=600)
            assert child.returncode == 0, log
            ref = np.load(os.path.join(tmp, f"{name}.npz"))
            meta = json.loads(str(ref["meta"]))
            out[name] = (ref["images"], meta["stats"], meta["configs"])
        return out


@pytest.mark.parametrize("key, pass_name", [
    ("blend_layers", "blend"), ("clip_layers", "clip"), ("particle_layers", "particle"),
])
def test_kbuffer_growth_past_the_kernel_templates_raises(deep_reference, key, pass_name):
    """A pass grows past the k-buffer kernel's largest template (16) as the
    reference's does: DEEP["n"] = 20 quads along the view ray (two at one
    depth) make the App grow the pass's K to 32 on the binned path
    (raster="auto": kbuffer_sorted, its plain version on CPU tensors) and
    re-render, and every frame's config, stats and image equal the
    reference App's (raster="pallas") -- the image bit for bit."""
    app = deep_stack(PORT_APP, pass_name, "auto", device="cpu")
    images_r, stats_r, configs_r = deep_reference[pass_name]
    for i in range(DEEP["frames"]):
        app.update()
        out = app.world.resource(FrameOutput)
        config = dataclasses.asdict(app.world.resource(RenderSettings).config)
        config_r = dict(configs_r[i], raster="auto")
        assert json.loads(json.dumps(config)) == config_r, i
        assert config[key] == 32, (i, config[key])
        stats = out.pending_stats[0].result()
        assert stats == stats_r[i], i
        assert stats[f"{pass_name}_layers_needed"] == DEEP["n"], i
        assert np.array_equal(out.image.numpy(), images_r[i]), i


def test_host_stats_equal_stats_to_host():
    """_HostStats (the asynchronous stats copy of the steady-state check)
    gives what stats_to_host gives, scalars and per-layer lists alike."""
    from superconductor_tpu_torch.render.frame import stats_to_host

    stats = {"pairs_needed": torch.tensor(7, dtype=torch.int32),
             "shade_px_needed_k": torch.tensor([3, 0, 5], dtype=torch.int32),
             "layers_needed": torch.tensor(2, dtype=torch.int32)}
    assert systems._HostStats(stats).result() == stats_to_host(stats)


# --- parity with the reference's App ----------------------------------------

_SCRIPT = dict(width=64, height=64, frames=4, dt=0.25, camera=[0.0, 1.0, 4.0],
               ribbon_at=[1.0, 0.0, 0.0])

_REFERENCE_CHILD = textwrap.dedent(
    """
    import dataclasses, json, sys, time
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, "tests")
    from conftest import make_box_glb, make_skinned_glb
    import superconductor_tpu.animation as animation
    from superconductor_tpu.assets.fetch import MemoryClient
    from superconductor_tpu.ecs import debugging
    from superconductor_tpu.ecs.app import App, Stage
    from superconductor_tpu.ecs.components import (
        AnimatedModelUrl, Instance, InstanceOf, JointsComponent, ModelComponent, ModelUrl)
    from superconductor_tpu.ecs.resources import CameraResource, FrameOutput, RenderSettings
    from superconductor_tpu.ecs.systems import CorePlugin
    from superconductor_tpu.math3d import Similarity
    from superconductor_tpu.render.frame import RenderConfig, stats_to_host

    if sys.argv[3] == "numpy":
        animation._joint_update_fn = False  # the numpy FK; "native" is the default
    script = json.loads(sys.argv[2])
    app = App()
    app.add_plugin(CorePlugin(
        config=RenderConfig(width=script["width"], height=script["height"], t_cap=64,
                            t_cap_anim=64, raster="ref"),
        client=MemoryClient({"box.glb": make_box_glb(), "ribbon.glb": make_skinned_glb()})))
    for fn in (debugging.push_joints_to_lines, debugging.push_bounding_boxes_to_lines,
               debugging.push_test_particles):
        app.add_system(Stage.INSTANCE_BUFFERING, fn)
    w = app.world
    w.resource(CameraResource).camera.position = np.array(script["camera"], np.float32)
    box_e = w.spawn(ModelUrl("box.glb"))
    w.spawn(Instance(Similarity()), InstanceOf(box_e))
    rib_e = w.spawn(AnimatedModelUrl("ribbon.glb"))
    inst_e = w.spawn(Instance(Similarity(translation=script["ribbon_at"])), InstanceOf(rib_e))
    deadline = time.time() + 120
    while w.get(box_e, ModelComponent) is None or w.get(rib_e, ModelComponent) is None:
        assert time.time() < deadline, "the models did not load"
        for fn in app._systems[Stage.ASSET_LOADING]:
            fn(w)
        time.sleep(0.01)
    out, images, palettes, stats, configs = {}, [], [], [], []
    for _ in range(script["frames"]):
        app.update()
        fo = w.resource(FrameOutput)
        jc = w.get(inst_e, JointsComponent)
        images.append(np.asarray(fo.image))
        palettes.append(np.asarray(jc.palette))
        stats.append(stats_to_host(fo.pending_stats[0]))
        configs.append(dataclasses.asdict(w.resource(RenderSettings).config))
        jc.time += script["dt"]
    np.savez(sys.argv[1], images=np.stack(images), palettes=np.stack(palettes),
             meta=json.dumps({"stats": stats, "configs": configs}))
    """
)


def _run_port():
    """The script through the port's App: (images, palettes, stats, configs)."""
    s = _SCRIPT
    app = App()
    app.add_plugin(CorePlugin(
        config=RenderConfig(width=s["width"], height=s["height"], t_cap=64, t_cap_anim=64,
                            raster="ref"),
        client=MemoryClient({"box.glb": box_glb(), "ribbon.glb": skinned_ribbon_glb()}),
        device="cpu",
    ))
    for fn in (debugging.push_joints_to_lines, debugging.push_bounding_boxes_to_lines,
               debugging.push_test_particles):
        app.add_system(Stage.INSTANCE_BUFFERING, fn)
    w = app.world
    w.resource(CameraResource).camera.position = np.array(s["camera"], np.float32)
    box_e = w.spawn(ModelUrl("box.glb"))
    w.spawn(Instance(Similarity()), InstanceOf(box_e))
    rib_e = w.spawn(AnimatedModelUrl("ribbon.glb"))
    inst_e = w.spawn(Instance(Similarity(translation=s["ribbon_at"])), InstanceOf(rib_e))
    # finish the loads without rendering, as the reference's child does
    deadline = time.time() + 120
    while w.get(box_e, ModelComponent) is None or w.get(rib_e, ModelComponent) is None:
        assert time.time() < deadline, "the models did not load"
        for fn in app._systems[Stage.ASSET_LOADING]:
            fn(w)
        time.sleep(0.01)
    images, palettes, stats, configs = [], [], [], []
    for _ in range(s["frames"]):
        app.update()
        out = w.resource(FrameOutput)
        jc = w.get(inst_e, JointsComponent)
        images.append(out.image.numpy())
        palettes.append(jc.palette.copy())
        stats.append(out.pending_stats[0].result())
        configs.append(dataclasses.asdict(w.resource(RenderSettings).config))
        jc.time += s["dt"]
    return images, palettes, stats, configs


@pytest.fixture(scope="module")
def reference_run():
    """mode -> the script through the reference's App, one child process
    for each joint path (JOINT_PATHS), run together."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
        env.pop("PYTHONPATH", None)
        children = {
            mode: subprocess.Popen(
                [sys.executable, "-c", _REFERENCE_CHILD, os.path.join(tmp, f"{mode}.npz"),
                 json.dumps(_SCRIPT), mode],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for mode in JOINT_PATHS
        }
        out = {}
        for mode, child in children.items():
            log, _ = child.communicate(timeout=600)
            assert child.returncode == 0, log
            ref = np.load(os.path.join(tmp, f"{mode}.npz"))
            meta = json.loads(str(ref["meta"]))
            out[mode] = (ref["images"], ref["palettes"], meta["stats"], meta["configs"])
        return out


@pytest.mark.parametrize("mode", JOINT_PATHS)
def test_app_matches_reference_app(reference_run, mode):
    """The port's App against the reference's, both with their joint FK on
    one path (test_torch_host.joint_path): the native walk, each package's
    default, or the numpy one."""
    images_r, palettes_r, stats_r, configs_r = reference_run[mode]
    with joint_path(mode):
        images_p, palettes_p, stats_p, configs_p = _run_port()
    assert len(images_p) == len(images_r) == _SCRIPT["frames"]
    # the growth loop settles on the same config, frame by frame (tuples
    # arrive from the child as JSON lists)
    assert json.loads(json.dumps(configs_p)) == configs_r
    assert configs_p[-1] == configs_p[-2]
    assert configs_p[-1]["enable_lines"] and configs_p[-1]["enable_particles"]
    for i in range(_SCRIPT["frames"]):
        assert palettes_p[i].dtype == palettes_r[i].dtype
        assert np.array_equal(palettes_p[i].view(np.uint8), palettes_r[i].view(np.uint8)), i
        assert images_p[i].shape == images_r[i].shape == (1, 64, 64, 4)
        assert psnr(images_r[i], images_p[i]) >= 40.0, i
        assert stats_p[i] == stats_r[i], i
    # the animation and the overlays are really in the frames
    assert not np.array_equal(images_p[0], images_p[-1])
    assert stats_p[-1]["particle_layers_needed"] >= 1

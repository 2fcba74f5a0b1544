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
  flip depth ties; tests/test_torch_raster.py) and on its numpy joint FK
  (test_torch_host.numpy_joint_update). The settled RenderConfigs are
  equal field by field, the joint palettes bit for bit, and every frame is
  >= 40 dB from the reference's (the goldens bar, tests/test_goldens.py:48)
  with an equal stats dict.
* The growth loop's port-specific rules: a k-buffer depth grown past the
  kernel's largest template raises, naming the pass and the K.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np
import pytest
import torch

import test_torch_host  # noqa: F401  (pins the reference's native library)
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

@pytest.mark.parametrize("key, pass_name", [
    ("blend_layers", "blend"), ("clip_layers", "clip"), ("particle_layers", "particle"),
])
def test_kbuffer_growth_past_the_kernel_templates_raises(key, pass_name):
    """On the binned path a K past the k-buffer kernel's largest template
    (KBUFFER_KS[-1] = 16) raises, naming the pass and the K; raster="ref"
    needs no template and grows freely, as the reference does."""
    with pytest.raises(ValueError, match=f"the {pass_name} pass needs a k-buffer of K=32"):
        systems._check_kbuffer_ks({key: 32}, RenderConfig(raster="auto"))
    systems._check_kbuffer_ks({key: 16}, RenderConfig(raster="auto"))
    systems._check_kbuffer_ks({key: 32}, RenderConfig(raster="ref"))


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

    animation._joint_update_fn = False  # the numpy FK, as the port's
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
    with tempfile.TemporaryDirectory() as tmp:
        dst = os.path.join(tmp, "reference.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
        env.pop("PYTHONPATH", None)
        out = subprocess.run(
            [sys.executable, "-c", _REFERENCE_CHILD, dst, json.dumps(_SCRIPT)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
        )
        assert out.returncode == 0, out.stdout + out.stderr
        ref = np.load(dst)
        meta = json.loads(str(ref["meta"]))
        return ref["images"], ref["palettes"], meta["stats"], meta["configs"]


def test_app_matches_reference_app(reference_run):
    images_r, palettes_r, stats_r, configs_r = reference_run
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

"""Multi-device rendering (parallel/bands.py) and the single-view helpers
of the port, on CPU device grids, against the port's own single-device
frame and against the reference.

* The sharded frame equals render_frame byte for byte on the 64x64 scenes
  of tests/test_multichip.py:33-81 (the stereo sphere; the clip and blend
  spheres in front of it) over grids of up to 2 views x 8 bands.
* The reference's render_frame_sharded on 8 virtual devices (2 eyes x 4
  bands, raster="ref") and its bin + interpret-mode raster of one view in
  2 bands under shard_map run in ONE child process whose XLA CPU backend
  is capped at AVX (FMA contraction moves the reference's setup rows and
  depths by ulps; tests/test_torch_raster.py), with the 8 devices forced
  there. The port's 2 x 4 frame is >= 40 dB from the reference's (the
  goldens bar, tests/test_goldens.py:48; measured: equal, inf dB); the
  port's band-split raster depth is bit for bit the whole view's and the
  reference kernel's.
* frame_capacity_stats and frame_capacity_report against the reference's
  on tests/test_render.py:121-135's box; render_view(geometry=None)
  against render_view given the geometry; the grid's errors."""

import functools
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from superconductor_tpu.render import frame as ref_frame
from superconductor_tpu.render.draws import build_frame_state as ref_build
from superconductor_tpu.utils import profiler as ref_profiler
from superconductor_tpu.utils.metrics import psnr
from superconductor_tpu_torch.ops.binning import bin_triangles, gather_sorted_setup
from superconductor_tpu_torch.ops.geometry import TriangleSetup
from superconductor_tpu_torch.ops.raster import rasterize_sorted
from superconductor_tpu_torch.ops.tonemap import to_u8
from superconductor_tpu_torch.parallel import make_render_mesh, render_frame_sharded
from superconductor_tpu_torch.render import frame as port_frame
from superconductor_tpu_torch.render.draws import build_frame_state
from superconductor_tpu_torch.render.frame import RenderConfig
from superconductor_tpu_torch.scene.scene import BLEND_ALPHA_BLENDED, BLEND_ALPHA_CLIPPED
from superconductor_tpu_torch.scene.upload import scene_to_torch
from superconductor_tpu_torch.scenes import HOST
from superconductor_tpu_torch.utils import profiler
from test_torch_host import REF_HOST

# The test workers share the CPU: torch's default of a thread per core in
# each of them oversubscribes it many times over.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = HEIGHT = 64  # tests/test_multichip.py's frame
CONFIG = dict(width=WIDTH, height=HEIGHT, t_cap=512, t_cap_anim=64, p_cap=2048)
TRANSPARENT = dict(enable_clip=True, enable_blend=True, shade_px_cap=1 << 12)
GRIDS = [(1, 1), (1, 2), (1, 8), (2, 1), (2, 2), (2, 4)]  # (views, bands)


def host_scene(host, stereo: bool, transparent: bool = False):
    """tests/test_multichip.py's _scene built with `host`'s modules ->
    (scene, instances, uniforms, env): a PBR sphere under a gradient
    cubemap and ambient SH, seen by one camera or two eyes 0.064 apart;
    with `transparent`, an alpha-clipped and an alpha-blended sphere in
    front of it."""
    m3 = host.math3d
    scene = host.Scene()
    model = host.add_pbr_sphere(scene, stacks=12, slices=12)
    extra = []
    if transparent:
        for name, mode in (("clip", BLEND_ALPHA_CLIPPED), ("blend", BLEND_ALPHA_BLENDED)):
            m = host.add_pbr_sphere(scene, stacks=10, slices=10, name=name)
            mat = scene.materials[m.primitives[0].material]
            mat.blend_mode = mode
            if mode == BLEND_ALPHA_BLENDED:
                mat.base_color_factor = (1.0, 0.5, 0.3, 0.5)
            m.primitives[0].blend_mode = mode
            extra.append(m)
        scene._materials_dirty = True
    cubemap_base = host.gradient_cubemap(scene, size=16)
    cam = host.Camera(position=np.array([0.0, 0.3, 2.4], np.float32))
    cam.rotation = m3.mat3_to_quat(m3.mat4_inverse(m3.look_at(cam.position, [0, 0, 0]))[:3, :3])
    env = host.EnvBindings(ibl_cubemap_base=cubemap_base, ambient_sh=host.default_ambient_sh())
    if stereo:
        ipd = np.array([0.032, 0, 0], np.float32)
        left = host.Camera(position=cam.position - ipd, rotation=cam.rotation)
        right = host.Camera(position=cam.position + ipd, rotation=cam.rotation)
        lu = host.make_uniforms(left, WIDTH, HEIGHT)
        ru = host.make_uniforms(right, WIDTH, HEIGHT)
        uniforms = host.make_stereo_uniforms(
            lu.view[0], ru.view[0], lu.projection[0], ru.projection[0],
            lu.eye[0], ru.eye[0], left.rotation, right.rotation,
        )
    else:
        uniforms = host.make_uniforms(cam, WIDTH, HEIGHT)
    instances = [(model, m3.Similarity())]
    for i, m in enumerate(extra):
        # in front of the opaque sphere so the k-buffer passes have work
        instances.append((m, m3.Similarity(translation=[0.5 - i, 0.0, 0.8 + 0.4 * i],
                                           scale=0.6)))
    return scene, instances, uniforms, env


@functools.lru_cache(maxsize=None)
def _port_inputs(num_views: int, transparent: bool):
    """(tables, FrameState, config, env) of the port's scene on the CPU."""
    scene, instances, uniforms, env = host_scene(HOST, num_views == 2, transparent)
    config = RenderConfig(**CONFIG, num_views=num_views, **(TRANSPARENT if transparent else {}))
    return (scene_to_torch(scene, "cpu"), build_frame_state(scene, instances, uniforms,
                                                            device="cpu"), config, env)


_REFERENCE_CHILD = textwrap.dedent(
    """
    import sys
    from functools import partial
    import jax
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    sys.path.insert(0, "tests")
    from superconductor_tpu.ops.binning import bin_triangles, gather_sorted_setup
    from superconductor_tpu.ops.raster_pallas import rasterize_pallas
    from superconductor_tpu.parallel.bands import make_render_mesh, render_frame_sharded
    from superconductor_tpu.render import frame as ref_frame
    from superconductor_tpu.render.draws import build_frame_state
    import test_torch_parallel as T
    from test_torch_host import REF_HOST

    devices = jax.devices("cpu")
    assert len(devices) == 8, devices
    out = {}

    # 2 eyes x 4 bands (tests/test_multichip.py:113)
    scene, instances, uniforms, env = T.host_scene(REF_HOST, stereo=True)
    config = ref_frame.RenderConfig(**T.CONFIG, num_views=2, raster="ref")
    dev = scene.device_arrays()
    state = build_frame_state(scene, instances, uniforms)
    mesh = make_render_mesh(devices, num_views=2)
    out["sharded"] = np.asarray(render_frame_sharded(dev, state, config, env, mesh))

    # one view's bin + interpret-mode raster in 2 bands (tests/test_multichip.py:148)
    scene, instances, uniforms, env = T.host_scene(REF_HOST, stereo=False)
    config = ref_frame.RenderConfig(**T.CONFIG)
    dev = scene.device_arrays()
    state = build_frame_state(scene, instances, uniforms)
    tri, _ = jax.jit(ref_frame._merged_geometry, static_argnames=("config",))(
        dev, state, state.uniforms["view_proj"][0], config=config)
    band_h = T.HEIGHT // 2

    @partial(jax.shard_map, mesh=Mesh(np.asarray(devices[:2]), ("band",)),
             in_specs=(P(),), out_specs=P("band"), check_vma=False)
    def shard_fn(tri_rep):
        y0 = jax.lax.axis_index("band") * band_h
        bins = bin_triangles(tri_rep, T.WIDTH, band_h, config.p_cap, y_offset=y0)
        ss = gather_sorted_setup(tri_rep, bins)
        vis = rasterize_pallas(ss, bins, band_h, T.WIDTH, y_offset=y0, interpret=True)
        return vis.depth[None]

    out["band_depth"] = np.asarray(jax.jit(shard_fn)(tri)).reshape(T.HEIGHT, T.WIDTH)
    for name, x in zip(tri._fields, tri):
        out["tri/" + name] = np.asarray(x)
    np.savez(sys.argv[1], **out)
    """
)


@pytest.fixture(scope="module")
def reference():
    """The reference's sharded frame and band-split raster, from the
    AVX-capped child with 8 virtual CPU devices."""
    with tempfile.TemporaryDirectory() as tmp:
        dst = os.path.join(tmp, "reference.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_cpu_max_isa=AVX --xla_force_host_platform_device_count=8")
        env.pop("PYTHONPATH", None)
        out = subprocess.run([sys.executable, "-c", _REFERENCE_CHILD, dst], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stdout + out.stderr
        return dict(np.load(dst))


@pytest.mark.parametrize("transparent", [False, True], ids=["opaque", "clip+blend"])
@pytest.mark.parametrize("views,bands", GRIDS)
def test_sharded_frame_equals_render_frame(views, bands, transparent):
    """Every view x band grid of "cpu" cells renders render_frame's image
    byte for byte; the k-buffer passes have fragments on the transparent
    scene, and the two eyes differ."""
    dev, state, config, env = _port_inputs(views, transparent)
    img, stats = port_frame.render_frame_stats(dev, state, config, env)
    mesh = make_render_mesh(["cpu"] * (views * bands), num_views=views)
    assert mesh.shape == {"view": views, "band": bands}
    out = render_frame_sharded(dev, state, config, env, mesh)
    assert out.shape == (views, HEIGHT, WIDTH, 4) and out.dtype == torch.uint8
    assert torch.equal(out, img)
    if transparent:
        stats = port_frame.stats_to_host(stats)
        assert stats["clip_layers_needed"] >= 1 and stats["blend_layers_needed"] >= 1
    if views == 2:
        assert not torch.equal(out[0], out[1])


def test_sharded_stereo_matches_reference(reference):
    """The port's 2 x 4 grid against the reference's render_frame_sharded
    on 2 x 4 virtual devices: >= 40 dB (measured: equal)."""
    dev, state, config, env = _port_inputs(2, False)
    out = render_frame_sharded(dev, state, config, env,
                               make_render_mesh(["cpu"] * 8, num_views=2)).numpy()
    ref = reference["sharded"]
    assert out.shape == ref.shape
    db = psnr(out, ref)
    assert db >= 40.0, db


def _band_depth(tri: TriangleSetup, bands: int, p_cap: int) -> torch.Tensor:
    """Depth of `tri` binned and rasterized in `bands` bands, stacked."""
    band_h = HEIGHT // bands
    out = []
    for b in range(bands):
        bins = bin_triangles(tri, WIDTH, band_h, p_cap, y_offset=b * band_h)
        vis = rasterize_sorted(gather_sorted_setup(tri, bins), bins.tile_start,
                               bins.tile_count, band_h, WIDTH, y_offset=b * band_h)
        out.append(vis.depth)
    return torch.cat(out)


def test_band_split_raster_matches_whole_view_and_reference(reference):
    """Bin + raster of one view in 2 bands: depth bit for bit equal to the
    whole view's, on the port's own setup rows, and to the reference's
    interpret kernel under shard_map on the reference's setup rows (the
    port's rows equal those bit for bit)."""
    dev, state, config, _env = _port_inputs(1, False)
    tri, _ = port_frame._merged_geometry(dev, state, state.uniforms["view_proj"][0], config)
    whole = _band_depth(tri, 1, config.p_cap)
    assert torch.equal(_band_depth(tri, 2, config.p_cap), whole)
    assert (whole != 0.0).any()
    ref_tri = TriangleSetup(*[torch.from_numpy(reference["tri/" + f])
                              for f in TriangleSetup._fields])
    for f in TriangleSetup._fields:  # unused rows hold NaN in both
        assert np.array_equal(getattr(tri, f).numpy(), getattr(ref_tri, f).numpy(),
                              equal_nan=True), f
    assert np.array_equal(_band_depth(ref_tri, 2, config.p_cap).numpy(),
                          reference["band_depth"])
    assert np.array_equal(whole.numpy(), reference["band_depth"])


def test_cells_raster_on_the_frames_tiles():
    """A triangle whose edge functions accept pixels outside its bounding
    box (as a near-degenerate one's can, from rounding): the binned raster
    covers every pixel of each tile its box touches, so a band [16, 48)
    binned on a tile grid of its own misses what the frame's tile [0, 32)
    covers, while the frame's tile rows that hold it (frame_tile_rows:
    [0, 64)) give the frame's rows."""
    from superconductor_tpu_torch.parallel.bands import frame_tile_rows

    setup = torch.tensor([[0.0, 0.0, 1.0] * 3 + [0.1] * 3 + [1.0] * 3 + [0.0]])
    tri = TriangleSetup(setup=setup, tri_id=torch.zeros(1, dtype=torch.int32),
                        inst_id=torch.zeros(1, dtype=torch.int32),
                        bbox=torch.tensor([[0, 0, 10, 3]], dtype=torch.int32),
                        valid=torch.ones(1, dtype=torch.bool),
                        num_valid=torch.ones((), dtype=torch.int32))

    def depth(rows, y_offset):
        bins = bin_triangles(tri, WIDTH, rows, 64, y_offset=y_offset)
        return rasterize_sorted(gather_sorted_setup(tri, bins), bins.tile_start,
                                bins.tile_count, rows, WIDTH, y_offset=y_offset).depth

    whole = depth(HEIGHT, 0)
    assert (whole[16:32] > 0).all() and not (whole[32:] > 0).any()
    assert not torch.equal(depth(32, 16), whole[16:48])
    top, bottom = frame_tile_rows(16, 48, RenderConfig(**CONFIG))
    assert (top, bottom) == (0, 64)
    assert torch.equal(depth(bottom - top, top)[16 - top:48 - top], whole[16:48])


@pytest.mark.parametrize("transparent", [False, True], ids=["opaque", "clip+blend"])
def test_render_view_computes_its_geometry(transparent):
    """render_view(geometry=None) on the right eye's band [32, 64) equals
    the same band given the precomputed geometry, byte for byte after
    to_u8, stats equal."""
    dev, state, config, env = _port_inputs(2, transparent)
    geometry = port_frame._merged_geometry(dev, state, state.uniforms["view_proj"][1], config)
    kw = dict(band_height=HEIGHT // 2, y_offset=HEIGHT // 2)
    img, stats = port_frame.render_view(dev, state, 1, config, env, **kw)
    img_g, stats_g = port_frame.render_view(dev, state, 1, config, env, geometry, **kw)
    assert torch.equal(to_u8(img), to_u8(img_g))
    assert port_frame.stats_to_host(stats) == port_frame.stats_to_host(stats_g)


@pytest.mark.parametrize("t_cap", [8, 512])
def test_frame_capacity_stats_matches_reference(box_glb, t_cap):
    """tests/test_render.py:121-135's box at 64x64: (triangles, bin pairs)
    equal to the reference's, and frame_capacity_report's warnings equal
    (12 triangles > t_cap 8 warns)."""
    kw = dict(width=64, height=64, t_cap=t_cap, t_cap_anim=8)
    counts = []
    for host, build, Config, stats_fn in (
        (REF_HOST, ref_build, ref_frame.RenderConfig, ref_frame.frame_capacity_stats),
        (HOST, functools.partial(build_frame_state, device="cpu"), RenderConfig,
         port_frame.frame_capacity_stats),
    ):
        scene = host.Scene()
        model = host.load_model(scene, box_glb, name="box")
        uniforms = host.make_uniforms(host.Camera(position=np.array([0, 0, 2.0], np.float32)),
                                      64, 64)
        state = build(scene, [(model, host.math3d.Similarity())], uniforms)
        dev = scene.device_arrays() if host is REF_HOST else scene_to_torch(scene, "cpu")
        ntri, npairs = stats_fn(dev, state, Config(**kw))
        counts.append((int(ntri), int(npairs)))
    assert counts[0] == counts[1]
    ntri, npairs = counts[1]
    assert ntri == 12 and npairs > 0  # the need, whatever t_cap holds
    warnings = profiler.frame_capacity_report(None, ntri, npairs, RenderConfig(**kw))
    assert warnings == ref_profiler.frame_capacity_report(None, ntri, npairs,
                                                          ref_frame.RenderConfig(**kw))
    assert bool(warnings) == (t_cap == 8)


def test_make_render_mesh_grid():
    """Cells take the devices in order, row by row; "cuda" without an
    index is never needed on the CPU, and a device may fill many cells."""
    mesh = make_render_mesh(["cpu"] * 6, num_views=2)
    assert mesh.axis_names == ("view", "band")
    assert mesh.shape == {"view": 2, "band": 3}
    assert all(mesh[v, b] == torch.device("cpu") for v in range(2) for b in range(3))


@pytest.mark.parametrize("case", ["no-cuda", "views-split", "band-split", "num-views"])
def test_grid_errors(case, monkeypatch):
    """No CUDA device with devices=None raises (there is no CPU fallback);
    so do a device count that does not split into the views, a height that
    does not split into the bands and a config whose num_views is not the
    grid's (where the reference asserts, parallel/bands.py:41, :59-61)."""
    if case == "no-cuda":
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_render_mesh()
        return
    if case == "views-split":
        with pytest.raises(ValueError, match="do not split"):
            make_render_mesh(["cpu"] * 3, num_views=2)
        return
    dev, state, config, env = _port_inputs(1, False)
    mesh = (make_render_mesh(["cpu"] * 3) if case == "band-split"
            else make_render_mesh(["cpu"] * 2, num_views=2))
    with pytest.raises(ValueError, match="bands" if case == "band-split" else "num_views"):
        render_frame_sharded(dev, state, config, env, mesh)

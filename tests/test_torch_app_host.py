"""The port's app-layer host modules on the CPU, against the reference's:

* render/present.py: the six cases of tests/test_present.py (fake frames
  and a fake clock; the default barrier waits on a CUDA event, so the
  fakes pass their own, which takes the frame and its event), and the
  CUDA barrier's behaviour on CPU tensors;
* render/rig.py: the five cases of tests/test_rig.py, each also held bit
  for bit against the reference's rig, and a scripted flight bit for bit;
* assets/texture_stream.py and the texture pool: the nine cases of
  tests/test_texture_stream.py and tests/test_texture_lifecycle.py (the
  dirty-range upload through scene/upload.py DeviceScene);
* DeviceScene: equal to scene_to_torch bit for bit after a model insert,
  a streamed texture swap, a free_texture, an IBL or light-volume load and
  a buffer growth; a 3-row write uploads 3 rows; nothing uploads or
  rebuilds when nothing changed;
* utils: metrics.psnr and profiler.frame_capacity_report equal to the
  reference's, device_trace, the PNG writer, build_gallery's
  FileNotFoundError without the Sponza textures;
* the frame server's capacity probe and the demo, run in a child process
  where importing jax or superconductor_tpu raises.
"""

import io
import os
import struct
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import test_torch_host  # noqa: F401  (pins the reference's native library)
from superconductor_tpu.render import rig as ref_rig
from superconductor_tpu.render.frame import RenderConfig as RefRenderConfig
from superconductor_tpu.utils import metrics as ref_metrics
from superconductor_tpu.utils import profiler as ref_profiler
from superconductor_tpu_torch.assets.environment import load_ibl_cubemap, load_lightvol
from superconductor_tpu_torch.assets.fetch import MemoryClient
from superconductor_tpu_torch.assets.models import load_model
from superconductor_tpu_torch.assets.texture_stream import TextureStreamer
from superconductor_tpu_torch.render import present
from superconductor_tpu_torch.render import rig as port_rig
from superconductor_tpu_torch.render.frame import RenderConfig
from superconductor_tpu_torch.scene.scene import MaterialSettings, Scene, TEX_DUMMY_WHITE
from superconductor_tpu_torch.scene.upload import DeviceScene, scene_to_torch
from superconductor_tpu_torch.scenes import HERO_GLB
from superconductor_tpu_torch.utils import gallery, image, metrics, profiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- render/present.py --------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeFrame:
    """Records when it was waited on; completing advances the clock."""

    def __init__(self, clock, render_time):
        self.clock = clock
        self.render_time = render_time
        self.blocked_at = None

    def block_until_ready(self):
        self.blocked_at = self.clock.t
        self.clock.t += self.render_time


def _block(frame, event):
    assert event is None  # no CUDA event for a fake frame
    frame.block_until_ready()


def test_depth1_blocks_every_submit():
    clock = FakeClock()
    q = present.PresentQueue(depth=1, clock=clock, sync=_block)
    f = FakeFrame(clock, render_time=0.5)
    lat = q.submit(f)
    assert f.blocked_at == 0.0
    assert lat == pytest.approx(0.5)
    assert len(q) == 0


def test_depth2_fills_then_blocks_oldest_in_fifo_order():
    clock = FakeClock()
    q = present.PresentQueue(depth=2, clock=clock, sync=_block)
    frames = [FakeFrame(clock, 0.25) for _ in range(3)]
    assert q.submit(frames[0]) is None  # filling: no wait yet
    assert frames[0].blocked_at is None and len(q) == 1
    lat1 = q.submit(frames[1])  # queue full -> the oldest completes
    assert frames[0].blocked_at is not None and frames[1].blocked_at is None
    assert lat1 == pytest.approx(0.25)
    assert q.submit(frames[2]) is not None
    assert frames[1].blocked_at is not None and frames[2].blocked_at is None
    rest = list(q.drain())
    assert frames[2].blocked_at is not None
    assert len(rest) == 1 and len(q) == 0


def test_latency_includes_queue_wait():
    clock = FakeClock()
    q = present.PresentQueue(depth=3, clock=clock, sync=_block)
    q.submit(FakeFrame(clock, 1.0))
    clock.t += 5.0  # host busy while the frame waits in the queue
    q.submit(FakeFrame(clock, 1.0))
    # first submitted at t=0, completed at t=6 -> 6 s, not 1 s
    assert q.submit(FakeFrame(clock, 1.0)) == pytest.approx(6.0)


def test_t_start_override_covers_input_phase():
    clock = FakeClock()
    q = present.PresentQueue(depth=1, clock=clock, sync=_block)
    t_input = clock.t
    clock.t += 0.2  # host draw-build between input and submit
    assert q.submit(FakeFrame(clock, 0.3), t_start=t_input) == pytest.approx(0.5)


def test_depth_validation():
    with pytest.raises(ValueError):
        present.PresentQueue(depth=0)


def test_custom_sync_barrier_used_instead_of_block():
    clock = FakeClock()
    synced = []

    def fake_probe(frame, event):
        synced.append(frame)
        clock.t += 0.4

    q = present.PresentQueue(depth=1, clock=clock, sync=fake_probe)
    f = FakeFrame(clock, render_time=99.0)
    lat = q.submit(f)
    assert synced == [f]
    assert f.blocked_at is None
    assert lat == pytest.approx(0.4)


@pytest.mark.parametrize("depth", [1, 2])
def test_cuda_barrier_returns_at_once_for_cpu_tensors(depth):
    """A CPU tensor is ready when it exists: no event is recorded for it
    and the default barrier (block_sync) does not wait; the latency is the
    clock's time from submit."""
    clock = FakeClock()
    q = present.PresentQueue(depth=depth, clock=clock)
    frame = torch.zeros((1, 4, 4, 4), dtype=torch.uint8)
    assert present.mark(frame) is None
    for _ in range(depth - 1):
        assert q.submit(frame) is None
    clock.t += 0.125
    assert q.submit(frame) == pytest.approx(0.125 if depth > 1 else 0.0)
    assert list(q.drain()) == [pytest.approx(0.0)] * (depth - 1)


# --- render/rig.py --------------------------------------------------------------

def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _both(make, drive):
    """drive(rig) on the port's rig and the reference's -> the port's
    results, after holding every result bit for bit against the reference's."""
    out_p = drive(make(port_rig))
    out_r = drive(make(ref_rig))
    for p, r in zip(out_p, out_r):
        if isinstance(p, (tuple, list)):
            assert all(_same_bits(x, y) for x, y in zip(p, r))
        else:
            assert _same_bits(p, r)
    return out_p


def test_rig_smooths_toward_target():
    def make(mod):
        rig = mod.FlyCameraRig(position=(0, 0, 0), position_smoothness=1.0)
        rig.target_pos = np.array([10.0, 0.0, 0.0], np.float32)
        return rig

    def drive(rig):
        first = rig.update(1 / 60)
        for _ in range(600):
            last = rig.update(1 / 60)
        return [first, last]

    first, last = _both(make, drive)
    assert 0 < first[0][0] < 10.0  # a partial step, not a snap
    assert abs(last[0][0] - 10.0) < 1e-2  # converges


def test_rig_wasd_moves_along_view():
    def drive(rig):
        for _ in range(60):
            rig.apply_keys({"w"}, dt=1 / 60)
            rig.update(1 / 60)
        return [rig.pos]

    (pos0,) = _both(lambda m: m.FlyCameraRig(position=(0, 0, 0), yaw=0.0, pitch=0.0,
                                             position_smoothness=0.0), drive)
    assert pos0[2] < -1.0 and abs(pos0[0]) < 1e-4  # yaw 0 faces -z
    (pos90,) = _both(lambda m: m.FlyCameraRig(position=(0, 0, 0), yaw=90.0,
                                              position_smoothness=0.0), drive)
    assert pos90[0] < -1.0  # yaw 90 faces -x


def test_rig_look_at_points_camera():
    from superconductor_tpu_torch.math3d import quat_rotate

    def drive(rig):
        rig.look_at((0, 0, 5), (0, 0, 0))
        first = rig.update(1.0)
        rig.look_at((5, 5, 0), (0, 0, 0))
        for _ in range(5):
            last = rig.update(1.0)
        return [first, last]

    first, last = _both(lambda m: m.FlyCameraRig(position_smoothness=0.0,
                                                 rotation_smoothness=0.0), drive)
    assert np.allclose(quat_rotate(first[1], np.array([0, 0, -1], np.float32)), [0, 0, -1],
                       atol=1e-3)
    expect = -np.array([5, 5, 0.0]) / np.linalg.norm([5, 5, 0])
    assert np.allclose(quat_rotate(last[1], np.array([0, 0, -1], np.float32)), expect,
                       atol=1e-2)


def test_camera_script_parse():
    text = "0-2 w\n3 w+d mouse=1,0.5\n# comment\n\n4-5 mouse=-2,0\n"
    script = port_rig.parse_camera_script(text)
    assert script == ref_rig.parse_camera_script(text)
    assert script[0] == ({"w"}, (0.0, 0.0))
    assert script[3] == ({"w", "d"}, (1.0, 0.5))
    assert script[5] == (set(), (-2.0, 0.0))
    assert 6 not in script


def test_rig_yaw_wraps_shortest_arc():
    def make(mod):
        rig = mod.FlyCameraRig()
        rig.yaw, rig.target_yaw = 175.0, -175.0  # 10 degrees apart across the seam
        rig.target_pitch = rig.pitch = 0.0
        rig.target_pos = rig.pos.copy()
        return rig

    def drive(rig):
        for _ in range(200):
            rig.update(1 / 60)
        converged = rig.yaw
        rig.yaw = 175.0
        rig.update(1 / 60)
        return [np.float64(converged), np.float64(rig.yaw)]

    converged, step = _both(make, drive)
    assert abs(((converged + 175.0 + 180.0) % 360.0) - 180.0) < 1e-3
    assert abs(step - 175.0) < 10.0  # a step never takes the long way round


def test_scripted_flight_matches_reference_bit_for_bit():
    """A 60-frame flight from a camera script (keys, boost, mouse, and a
    look_at waypoint halfway): every pose equal to the reference rig's."""
    text = ("0-9 w\n10-19 w+d mouse=2,0.5\n20-29 mouse=-3,1\n"
            "30-39 s+shift+e\n40-59 a+q mouse=0.5,-0.2\n")

    def make(mod):
        return mod.FlyCameraRig(position=(1.0, 2.0, 3.0), yaw=10.0, pitch=-5.0)

    def drive(rig):
        mod = sys.modules[type(rig).__module__]
        script = mod.parse_camera_script(text)
        poses = []
        for f in range(60):
            keys, mouse = script.get(f, (set(), (0.0, 0.0)))
            rig.apply_keys(keys, dt=1 / 60, mouse=mouse)
            if f == 25:
                rig.look_at((5.0, 5.0, 0.0), (0.0, 0.0, 0.0))
            poses.append(rig.update(1 / 60))
        return poses

    poses = _both(make, drive)
    assert len(poses) == 60 and not np.allclose(poses[0][0], poses[-1][0])


# --- texture streaming and the pool's lifecycle ---------------------------------

def _png_bytes(color=(30, 200, 60, 255), size=8):
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGBA", (size, size), color).save(buf, format="PNG")
    return buf.getvalue()


def _textured_quad_gltf():
    """A glTF (json) quad whose material's albedo is an external PNG."""
    import json

    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    blob = pos.tobytes() + uv.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                                    "indices": 2, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}}],
        "textures": [{"source": 0}],
        "images": [{"uri": "tex.png"}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3",
             "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC2"},
            {"bufferView": 2, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 48},
            {"buffer": 0, "byteOffset": 48, "byteLength": 32},
            {"buffer": 0, "byteOffset": 80, "byteLength": 12},
        ],
        "buffers": [{"uri": "geom.bin", "byteLength": len(blob)}],
    }
    return json.dumps(doc).encode(), blob


def _quad_client():
    gltf, blob = _textured_quad_gltf()
    client = MemoryClient({"scene.gltf": gltf, "geom.bin": blob, "tex.png": _png_bytes()})
    client.resolve = lambda base, rel: rel
    return client, gltf


def make_rgba8_ktx2(levels):
    """A minimal uncompressed RGBA8 KTX2 of a mip chain (finest first)."""
    n = len(levels)
    h0, w0 = levels[0].shape[:2]
    header = struct.pack("<9I", 37, 1, w0, h0, 0, 0, 1, n, 0)
    index_off = 12 + 48 + 20 + n * 24
    offsets, payloads = [], b""
    for lvl in reversed(levels):  # smallest level first in the file
        b = lvl.tobytes()
        offsets.append((index_off + len(payloads), len(b), len(b)))
        payloads += b
    index = b"".join(struct.pack("<3Q", *o) for o in offsets[::-1])
    return (b"\xabKTX 20\xbb\r\n\x1a\n" + header + struct.pack("<4I2Q", 0, 0, 0, 0, 0, 0)
            + index + payloads)


def _chain(color, size=8):
    levels, s = [], size
    while True:
        levels.append(np.full((s, s, 4), color, np.uint8))
        if s == 1:
            return levels
        s //= 2


def _pump_until(streamer, scene, pred, timeout=10.0, each=None):
    deadline = time.time() + timeout
    while time.time() < deadline:
        streamer.pump(scene)
        if each is not None:
            each()
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_async_texture_hot_swap():
    client, gltf = _quad_client()
    scene = Scene()
    streamer = TextureStreamer(client)
    model = load_model(scene, gltf, url="scene.gltf", client=client, streamer=streamer)
    mat = scene.materials[model.primitives[0].material]
    assert mat.albedo_tex == TEX_DUMMY_WHITE  # the dummy until the decode lands
    assert _pump_until(streamer, scene, lambda: mat.albedo_tex != TEX_DUMMY_WHITE)
    base = scene.textures.tex_mip_base[mat.albedo_tex]
    texel = scene.textures.texels.host[scene.textures.mip_offset[base]]
    assert texel[1] > 150 and texel[0] < 80


def test_sync_load_unchanged():
    client, gltf = _quad_client()
    scene = Scene()
    model = load_model(scene, gltf, url="scene.gltf", client=client)
    assert scene.materials[model.primitives[0].material].albedo_tex != TEX_DUMMY_WHITE


def test_progressive_stream_no_stranded_texels():
    chain = _chain((10, 200, 30, 255), size=8)
    scene = Scene()
    streamer = TextureStreamer(MemoryClient({"tex.ktx2": make_rgba8_ktx2(chain)}))
    mat = scene.add_material(MaterialSettings())
    used_before = scene.textures.texels.alloc.used()
    streamer.request(mat, "albedo_tex", "tex.ktx2", srgb=True)
    assert _pump_until(streamer, scene, lambda: scene.materials[mat].albedo_tex
                       != TEX_DUMMY_WHITE and streamer.idle)
    tex_id = scene.materials[mat].albedo_tex
    assert scene.textures.tex_mip_count[tex_id] == len(chain)
    base = scene.textures.tex_mip_base[tex_id]
    assert scene.textures.texels.host[scene.textures.mip_offset[base]][1] == 200
    chain_texels = sum(lvl.shape[0] * lvl.shape[1] for lvl in chain)
    assert scene.textures.texels.alloc.used() - used_before == chain_texels


def test_preview_phase_restricts_mip_view():
    chain = _chain((90, 40, 250, 255), size=16)

    class SlowClient(MemoryClient):
        def fetch_bytes(self, url):  # delays the full-chain phase
            time.sleep(0.4)
            return super().fetch_bytes(url)

    scene = Scene()
    streamer = TextureStreamer(SlowClient({"tex.ktx2": make_rgba8_ktx2(chain)}))
    mat = scene.add_material(MaterialSettings())
    streamer.request(mat, "albedo_tex", "tex.ktx2", srgb=False)
    assert _pump_until(streamer, scene,
                       lambda: scene.materials[mat].albedo_tex != TEX_DUMMY_WHITE)
    tex_id = scene.materials[mat].albedo_tex
    if scene.textures.tex_mip_count[tex_id] == 1:  # still in preview
        base = scene.textures.tex_mip_base[tex_id]
        assert scene.textures.mip_w[base] == 1
        assert scene.textures.texels.host[scene.textures.mip_offset[base]][2] == 250
    assert _pump_until(streamer, scene,
                       lambda: scene.textures.tex_mip_count[tex_id] == len(chain))


def test_late_requester_served_from_loaded_texture():
    scene = Scene()
    streamer = TextureStreamer(MemoryClient({"tex.ktx2": make_rgba8_ktx2(
        _chain((255, 128, 0, 255), size=4))}))
    mat_a = scene.add_material(MaterialSettings())
    streamer.request(mat_a, "albedo_tex", "tex.ktx2", srgb=True)
    assert _pump_until(streamer, scene, lambda: scene.materials[mat_a].albedo_tex
                       != TEX_DUMMY_WHITE and streamer.idle)
    mat_b = scene.add_material(MaterialSettings())
    streamer.request(mat_b, "emissive_tex", "tex.ktx2", srgb=True)
    streamer.pump(scene)
    assert scene.materials[mat_b].emissive_tex == scene.materials[mat_a].albedo_tex


def test_free_texture_returns_ranges():
    scene = Scene()
    used0 = scene.textures.texels.alloc.used()
    tex = scene.textures.add_texture(_chain((1, 2, 3, 4), size=8))
    assert scene.textures.texels.alloc.used() > used0
    scene.textures.free_texture(tex)
    assert scene.textures.texels.alloc.used() == used0


def test_growable_dirty_range_upload_correct():
    """The reference's GrowableArray.device() test through DeviceScene: the
    resident tensor equals the host after a push, a small in-place write
    (a ranged copy of its rows only) and a growth (a whole upload)."""
    scene = Scene()
    ds = DeviceScene(scene, "cpu")
    g = scene.tri_material.array
    g.push(np.arange(g.capacity, dtype=np.int32) % 251)
    d0 = ds.arrays()["tri_material"].clone()
    assert np.array_equal(d0.numpy(), g.host)
    g.write(10, np.full(3, 77, np.int32))
    d1 = ds.arrays()["tri_material"]
    assert np.array_equal(d1.numpy(), g.host)
    assert d1[10] == 77 and d1[13] == d0[13]
    assert ds.last_upload == {"tri_material": 3 * 4}
    g.push(np.zeros(100, np.int32))  # past capacity: grows
    d2 = ds.arrays()["tri_material"]
    assert np.array_equal(d2.numpy(), g.host) and d2.shape[0] == g.capacity > d0.shape[0]
    assert ds.last_upload == {"tri_material": g.host.nbytes}


def test_final_fetch_failure_keeps_preview_and_serves_late_requesters():
    chain = _chain((10, 220, 30, 255), size=8)

    class FailingFinalClient(MemoryClient):
        def fetch_bytes_range(self, url, start, end):  # phase 1
            return self.files[url][start:end]

        def fetch_bytes(self, url):  # phase 2 only
            raise IOError("final fetch failed")

    scene = Scene()
    streamer = TextureStreamer(FailingFinalClient({"tex.ktx2": make_rgba8_ktx2(chain)}))
    mat = scene.add_material(MaterialSettings())
    streamer.request(mat, "albedo_tex", "tex.ktx2", srgb=False)
    assert _pump_until(streamer, scene, lambda: scene.materials[mat].albedo_tex
                       != TEX_DUMMY_WHITE and streamer.idle)
    tex_id = scene.materials[mat].albedo_tex
    assert scene.textures.tex_mip_count[tex_id] == 1  # the preview is bound
    base = scene.textures.tex_mip_base[tex_id]
    assert tuple(scene.textures.texels.host[scene.textures.mip_offset[base]]) == (10, 220, 30, 255)
    mat_b = scene.add_material(MaterialSettings())
    streamer.request(mat_b, "emissive_tex", "tex.ktx2", srgb=False)
    streamer.pump(scene)
    assert scene.materials[mat_b].emissive_tex == tex_id


def test_free_texture_descriptor_stays_safe():
    scene = Scene()
    a = scene.textures.add_texture(_chain((9, 9, 9, 9), size=4))
    b = scene.textures.add_texture(_chain((7, 7, 7, 7), size=4))
    scene.textures.free_texture(b)
    assert scene.textures.tex_mip_count[b] == 1
    base = scene.textures.tex_mip_base[b]
    assert scene.textures.mip_offset[base] == 0
    assert scene.textures.mip_w[base] == 1 and scene.textures.mip_h[base] == 1
    used = scene.textures.texels.alloc.used()
    scene.textures.free_texture(b)  # idempotent
    assert scene.textures.texels.alloc.used() == used
    off_a = scene.textures.mip_offset[scene.textures.tex_mip_base[a]]
    assert tuple(scene.textures.texels.host[off_a]) == (9, 9, 9, 9)


# --- DeviceScene against scene_to_torch -----------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _assert_resident_equals_rebuild(ds: DeviceScene):
    got, want = _flat(ds.arrays()), _flat(scene_to_torch(ds.scene, "cpu"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(_bits(got[k]), _bits(want[k])), k  # bitcast rows hold NaN patterns


def _ktx2(vk_format, images, depth=0, faces=1):
    """One uncompressed KTX2 level of z slices or faces (test_torch_lit)."""
    h, w = images[0].shape[:2]
    header = struct.pack("<9I", vk_format, images[0].dtype.itemsize, w, h, depth, 0, faces, 1, 0)
    payload = b"".join(np.ascontiguousarray(i).tobytes() for i in images)
    return (b"\xabKTX 20\xbb\r\n\x1a\n" + header + struct.pack("<4I2Q", 0, 0, 0, 0, 0, 0)
            + struct.pack("<3Q", 12 + 48 + 20 + 24, len(payload), len(payload)) + payload)


def _mutate(which: str, scene: Scene, ds: DeviceScene):
    rng = np.random.default_rng(3)
    if which == "model insert":
        with open(HERO_GLB, "rb") as f:
            load_model(scene, f.read(), name="hero")
    elif which == "streamed texture swap":
        streamer = TextureStreamer(MemoryClient({"tex.ktx2": make_rgba8_ktx2(
            _chain((40, 90, 160, 255), size=16))}))
        mat = scene.add_material(MaterialSettings())
        streamer.request(mat, "albedo_tex", "tex.ktx2", srgb=True)
        # held after every pump: the preview view and the final chain alike
        assert _pump_until(streamer, scene, lambda: streamer.idle and scene.materials[mat]
                           .albedo_tex != TEX_DUMMY_WHITE,
                           each=lambda: _assert_resident_equals_rebuild(ds))
    elif which == "free_texture":
        tex = scene.textures.add_texture(_chain((5, 6, 7, 8), size=8))
        _assert_resident_equals_rebuild(ds)
        scene.textures.free_texture(tex)
    elif which == "IBL load":
        load_ibl_cubemap(scene, _ktx2(97, [rng.uniform(0, 3, (8, 8, 4)).astype(np.float16)
                                           for _ in range(6)], faces=6))
    elif which == "light-volume load":
        files = [_ktx2(97, [rng.uniform(0, 3, (8, 12, 4)).astype(np.float16)
                            for _ in range(6)], depth=6)]
        files += [_ktx2(37, [rng.integers(0, 256, (8, 12, 4), dtype=np.uint8)
                             for _ in range(6)], depth=6) for _ in range(3)]
        load_lightvol(scene, *files, bottom_left=(-2.0, 0.0, -1.0), scale=(4.0, 2.0, 3.0))
        assert "lv_sh" in ds.arrays()
    elif which == "buffer growth":
        cap = scene.positions.capacity
        n = cap + 5
        for name in ("positions", "normals"):
            getattr(scene, name).insert(rng.standard_normal((n, 3)).astype(np.float32))
        assert scene.positions.capacity > cap


@pytest.mark.parametrize("which", ["model insert", "streamed texture swap", "free_texture",
                                   "IBL load", "light-volume load", "buffer growth"])
def test_device_scene_equals_scene_to_torch(which):
    scene = Scene()
    ds = DeviceScene(scene, "cpu")
    _assert_resident_equals_rebuild(ds)
    _mutate(which, scene, ds)
    _assert_resident_equals_rebuild(ds)
    # nothing changed since: nothing uploads, no pool is gathered again
    rebuilds = dict(ds.rebuilds)
    ds.arrays()
    assert ds.last_upload == {} and dict(ds.rebuilds) == rebuilds


def test_device_scene_small_write_uploads_its_rows():
    """3 rows written into a vertex buffer of the hero's scene move 3 rows
    (36 bytes of positions), not the buffer, and rebuild no derived pool."""
    scene = Scene()
    with open(HERO_GLB, "rb") as f:
        load_model(scene, f.read(), name="hero")
    ds = DeviceScene(scene, "cpu")
    first = ds.arrays()
    assert ds.bytes_uploaded > scene.positions.host.nbytes
    rebuilds = dict(ds.rebuilds)
    scene.positions.array.write(100, np.full((3, 3), 0.5, np.float32))
    d = ds.arrays()
    assert ds.last_upload == {"positions": 3 * 3 * 4}
    assert d["positions"] is first["positions"]  # updated in place
    assert dict(ds.rebuilds) == rebuilds
    _assert_resident_equals_rebuild(ds)
    # a texel write re-gathers the quad pools built from it, on the device
    tex = scene.materials[0].albedo_tex
    base = scene.textures.tex_mip_base[tex]
    h, w = scene.textures.mip_h[base], scene.textures.mip_w[base]
    scene.textures.write_level(tex, 0, np.zeros((h, w, 4), np.uint8))
    ds.arrays()
    assert ds.last_upload == {"texels": h * w * 4}
    assert ds.rebuilds["texels_q"] == rebuilds["texels_q"] + 1
    _assert_resident_equals_rebuild(ds)


def test_a_replaced_device_scene_raises():
    """The dirty state goes to the DeviceScene made last on a scene (as the
    ECS makes a new one when the device changes): it uploads everything and
    stays equal to a rebuild, and the one it replaced raises if called."""
    scene = Scene()
    a = DeviceScene(scene, "cpu")
    a.arrays()
    scene.positions.insert(np.ones((4, 3), np.float32))
    b = DeviceScene(scene, "cpu")
    _assert_resident_equals_rebuild(b)
    scene.positions.insert(np.full((2, 3), 2.0, np.float32))
    _assert_resident_equals_rebuild(b)
    with pytest.raises(RuntimeError, match="newer DeviceScene"):
        a.arrays()


# --- utils -------------------------------------------------------------------

def test_psnr_matches_reference():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (16, 16, 4), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-3, 4, a.shape), 0, 255).astype(np.uint8)
    assert metrics.psnr(a, b) == ref_metrics.psnr(a, b)
    assert metrics.psnr(a, a) == ref_metrics.psnr(a, a) == float("inf")
    assert metrics.psnr(a, b, 1.0) == ref_metrics.psnr(a, b, 1.0)


@pytest.mark.parametrize("tris, pairs", [(10, 10), (100, 10), (10, 1 << 20), (1 << 20, 1 << 20)])
def test_frame_capacity_report_matches_reference(tris, pairs):
    kw = dict(t_cap=64, p_cap=1 << 16)
    got = profiler.frame_capacity_report(None, tris, pairs, RenderConfig(**kw))
    assert got == ref_profiler.frame_capacity_report(None, tris, pairs, RefRenderConfig(**kw))


def test_frame_profiler_scopes_and_device_trace(tmp_path):
    prof = profiler.FrameProfiler()
    with prof.scope("a"):
        pass
    with prof.scope("a"):
        pass
    assert prof.counts["a"] == 2 and "a: " in prof.report()
    with profiler.device_trace(str(tmp_path)) as trace:
        torch.ones(64).sum()
    assert os.path.getsize(tmp_path / "trace.json") > 0 and trace.key_averages()


def test_png_writer_round_trips():
    from PIL import Image

    rng = np.random.default_rng(1)
    for shape in ((7, 5, 4), (3, 9, 3)):
        a = rng.integers(0, 256, shape, dtype=np.uint8)
        assert np.array_equal(np.asarray(Image.open(io.BytesIO(image.encode_png(a)))), a)


def test_build_gallery_needs_the_sponza_textures(monkeypatch, tmp_path):
    """Without the Sponza textures build_gallery raises FileNotFoundError,
    as the reference's does; the port looks for them under ASSETS_DIR."""
    from superconductor_tpu_torch.assets import ASSETS_DIR

    assert gallery.SPONZA_TEX_DIR.startswith(ASSETS_DIR)
    monkeypatch.setattr(gallery, "SPONZA_TEX_DIR", str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError):
        gallery.build_gallery(Scene())


# --- the frame server and the demo, with jax and the reference blocked ------

_BLOCKED = textwrap.dedent(
    """
    import runpy, sys

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "superconductor_tpu"):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Blocker())
    sys.argv = [sys.argv[1]] + sys.argv[2:]
    try:
        runpy.run_module(sys.argv[0], run_name="__main__")
    except SystemExit as e:
        if e.code:
            raise
    assert "jax" not in sys.modules and "superconductor_tpu" not in sys.modules
    """
)


def _blocked_child(module, *args, stdin_text=None):
    env = dict(os.environ, OMP_NUM_THREADS="2")  # the test workers share the CPU
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", _BLOCKED, module, *args], cwd=REPO, env=env,
                          input=stdin_text, capture_output=True, text=True, timeout=600)


def test_serve_probe_only_runs_blocked():
    """The capacity probe's body: the stats-on sweep through the ECS on the
    terrain, reporting the caps its growth loop settled on."""
    import json

    out = _blocked_child("superconductor_tpu_torch.serve", "--probe-only", "--size", "64x36",
                         "--device", "cpu", "--raster", "ref")
    assert out.returncode == 0, out.stdout + out.stderr
    caps = json.loads(out.stdout.strip().splitlines()[-1])
    assert caps["p_cap"] >= 1 and caps["blend_layers"] >= 1
    assert caps["opaque_px_cap"] is not None  # seeded by the stats-on loop


def test_demo_runs_blocked(tmp_path):
    out = _blocked_child("superconductor_tpu_torch.demo", "--frames", "2", "--size", "64x36",
                         "--device", "cpu", "--out", str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    from PIL import Image

    frames = sorted(os.listdir(tmp_path))
    assert frames == ["frame_000.png", "frame_001.png"]
    img = np.asarray(Image.open(tmp_path / frames[1]))
    assert img.shape == (36, 64, 4) and img[..., :3].std() > 1.0


def test_serve_stdin_runs_blocked(tmp_path):
    """The interactive server (--stdin) with the probe off and 2 frames in
    flight: a bad line, two input frames (the first queued, the second
    answered with its latency), a save of the newest frame, a quit."""
    import json

    png = str(tmp_path / "frame.png")
    cmds = ["not json", json.dumps({"keys": "w", "mouse": [1.0, 0.0]}),
            json.dumps({"keys": "w+d"}), json.dumps({"save": png}), json.dumps({"quit": True}),
            json.dumps({"keys": "s"})]  # after the quit: never read
    out = _blocked_child("superconductor_tpu_torch.serve", "--stdin", "--size", "64x36",
                         "--device", "cpu", "--raster", "ref", "--probe", "off",
                         "--frames-in-flight", "2", stdin_text="\n".join(cmds) + "\n")
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert lines[0] == {"error": "bad json"}
    assert lines[1] == {"frame": 1, "queued": True}
    assert lines[2]["frame"] == 2 and lines[2]["latency_ms"] >= 0
    assert lines[2]["p50_ms"] == lines[2]["p99_ms"] == lines[2]["latency_ms"]
    assert lines[3:] == [{"saved": png}]
    assert "probe" not in out.stderr  # --probe off runs no capacity probe
    from PIL import Image

    img = np.asarray(Image.open(png))
    assert img.shape == (36, 64, 4) and img[..., :3].std() > 1.0


def test_demo_fly_path_follows_its_script(tmp_path):
    """--path fly --script FILE: the camera flies the script's keys and
    mouse, as the reference's rig flies them from demo/demo.py's start
    pose, and the frames move; --debug-lines turns the lines pass on."""
    from superconductor_tpu_torch import demo
    from superconductor_tpu_torch.ecs.resources import CameraResource, RenderSettings

    script = "0-1 w+d mouse=2,0.5\n2 s+q\n"
    path = tmp_path / "fly.txt"
    path.write_text(script)
    app, info = demo.run(["--frames", "3", "--size", "32x18", "--device", "cpu",
                          "--raster", "ref", "--path", "fly", "--script", str(path),
                          "--debug-lines", "--out", str(tmp_path / "out")])
    cam = app.world.resource(CameraResource).camera
    assert app.world.resource(RenderSettings).config.enable_lines

    rig = ref_rig.FlyCameraRig(position=(8.0, 2.0, 3.0), speed=6.0)
    rig.look_at((8.0, 2.0, 3.0), (0, 1.5, 0))
    rig.pos = rig.target_pos.copy()
    rig.yaw, rig.pitch = rig.target_yaw, rig.target_pitch
    rig.update(0.0)
    steps = ref_rig.parse_camera_script(script)
    for n in range(3):
        keys, mouse = steps.get(n, (set(), (0.0, 0.0)))
        rig.apply_keys(keys, dt=1 / 60.0, mouse=mouse)
        pos, rot = rig.update(1 / 60.0)
    assert _same_bits(cam.position, pos) and _same_bits(cam.rotation, rot)
    assert not np.allclose(pos, (8.0, 2.0, 3.0))
    from PIL import Image

    frames = [np.asarray(Image.open(p)) for p in info["paths"]]
    assert not np.array_equal(frames[0], frames[2])

"""raster="ref": the port's brute-force rasters against the reference's,
and frames rendered with them against the binned raster's.

rasterize_ref and rasterize_kbuffer_ref take the SAME setup rows as the
reference's (the port's, bit-exact with the eager reference,
tests/test_torch_geometry.py) and must equal it bit for bit in depth, pair
and layers. The reference runs in a child process whose XLA CPU backend is
capped at AVX: XLA contracts the multiply-adds of the edge and z sums into
FMAs wherever the ISA has them, and only without FMA does every product and
sum round on its own, as the port's do. In this process the reference's
rounding differs; test_in_process_gap states by how much.

A raster="ref" frame equals its raster="auto" frame byte for byte: both
rasters keep, per pixel, the first of the nearest fragments in the rows'
order (the binning keeps that order within a tile), and the K nearest by
the same order; only the pair ids they leave differ (original row indices
against sorted positions), and the frame gathers its tables accordingly."""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_tpu.ops import raster_kbuffer as ref_kbuffer
from superconductor_tpu.ops import raster_ref as ref_raster
from superconductor_tpu_torch.math3d import Similarity, quat_from_axis_angle
from superconductor_tpu_torch.ops.raster_kbuffer import rasterize_kbuffer_ref
from superconductor_tpu_torch.ops.raster_ref import (
    VisibilityBuffer,
    empty_visibility,
    rasterize_ref,
)
from superconductor_tpu_torch.render import frame as port_frame
from superconductor_tpu_torch.render.caps import fit_caps
from superconductor_tpu_torch.render.draws import build_frame_state
from superconductor_tpu_torch.render.frame import _merged_setup_for_view, _merged_vertex_stage
from superconductor_tpu_torch.scene.upload import scene_to_torch
from superconductor_tpu_torch.scenes import (
    all_passes_scene,
    clip_blend_scene,
    headline_host,
    headline_scene,
    heavy_tile_setup,
    quad_stack_setup,
)

# The test workers share the CPU: torch's default of a thread per core in
# each of them oversubscribes it many times over.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _hero_setup(width, height):
    """The port's setup rows of the hero at 0.3 rad, every triangle."""
    scene, model, uniforms, _env, config = headline_host(width, height)
    state = build_frame_state(
        scene, [(model, Similarity(rotation=quat_from_axis_angle([0, 1, 0], 0.3)))], uniforms,
        device="cpu",
    )
    stages, _ = _merged_vertex_stage(scene_to_torch(scene, "cpu"), state, config)
    return _merged_setup_for_view(stages, state.uniforms["view_proj"][0], config)


def _some_invalid(tri):
    """The valid rows of `tri` in their order, and every 64th invalid one."""
    keep = tri.valid | (torch.arange(tri.valid.shape[0]) % 64 == 0)
    return tri._replace(**{f: getattr(tri, f)[keep] for f in tri._fields if f != "num_valid"})


@functools.lru_cache(maxsize=None)
def _cases() -> dict:
    """name -> (setup rows, width, height, reverse_z, y_offset, init or
    floor (depth, pair) arrays or None): the hero at 160x96 (its valid
    rows and some invalid ones, so the reference's walk stays short) in both z
    directions, a band [24, 72) of it over an init buffer (random depths
    under its surface and random pair ids, numpy seed) that also serves as
    the k-buffer's floor, the quad stack (equal-z ties, 12 layers) in both
    z directions, and one tile of 2,200 small triangles each drawn twice."""
    rng = np.random.default_rng(31)
    hero = _some_invalid(_hero_setup(160, 96))
    init = (rng.uniform(0.0, 0.04, size=(48, 160)).astype(np.float32),
            rng.integers(-1, 400, size=(48, 160)).astype(np.int32))
    return {
        "hero": (hero, 160, 96, True, 0, None),
        "hero-forward-z": (hero, 160, 96, False, 0, None),
        "hero-band-init": (hero, 160, 48, True, 24, init),
        "stack": (quad_stack_setup(200, 80, "cpu"), 200, 80, True, 0, None),
        "stack-forward-z": (quad_stack_setup(200, 80, "cpu", reverse_z=False), 200, 80,
                            False, 0, None),
        "heavy": (heavy_tile_setup(320, 96, "cpu"), 320, 96, True, 0, None),
    }


# (case, K) of rasterize_kbuffer_ref; the hero band takes its init depth
# as the floor
KB_RUNS = (("stack", 1), ("stack", 4), ("stack", 16), ("stack-forward-z", 8),
           ("hero", 2), ("hero-band-init", 4), ("heavy", 8))

_REFERENCE_CHILD = textwrap.dedent(
    """
    import sys
    import jax.numpy as jnp
    import numpy as np
    from superconductor_tpu.ops.geometry import TriangleSetup
    from superconductor_tpu.ops.raster_kbuffer import rasterize_kbuffer_ref
    from superconductor_tpu.ops.raster_ref import VisibilityBuffer, rasterize_ref

    cases = np.load(sys.argv[1])
    out = {}
    for name in sorted({k.split("/")[0] for k in cases.files}):
        def get(key):
            return jnp.asarray(cases[name + "/" + key])
        tri = TriangleSetup(**{f: get(f) for f in TriangleSetup._fields})
        height, width, reverse_z, y_offset = (int(v) for v in cases[name + "/meta"])
        init = None
        if name + "/init_depth" in cases.files:
            init = VisibilityBuffer(get("init_depth"), get("init_pair"))
        vis = rasterize_ref(tri, height, width, reverse_z=bool(reverse_z), init=init,
                            y_offset=y_offset)
        out[name + "/depth"] = np.asarray(vis.depth)
        out[name + "/pair"] = np.asarray(vis.pair)
        for k in (int(k) for k in cases[name + "/ks"]):
            kb, layers = rasterize_kbuffer_ref(
                tri, height, width, k=k, reverse_z=bool(reverse_z),
                depth_floor=None if init is None else init.depth, y_offset=y_offset,
            )
            out[f"{name}:{k}/depth"] = np.asarray(kb.depth)
            out[f"{name}:{k}/pair"] = np.asarray(kb.pair)
            out[f"{name}:{k}/layers"] = np.asarray(layers)
    np.savez(sys.argv[2], **out)
    """
)


@pytest.fixture(scope="module", autouse=True)
def _reference_child(tmp_path_factory):
    """The reference's rasterize_ref on every case and its
    rasterize_kbuffer_ref on every KB_RUNS entry, in ONE child process
    capped at AVX (no FMA contraction). It starts with the module's first
    test and runs while the frame tests render; `reference` waits for it."""
    arrays = {}
    for name, (tri, width, height, reverse_z, y_offset, init) in _cases().items():
        for f in tri._fields:
            arrays[f"{name}/{f}"] = getattr(tri, f).numpy()
        arrays[name + "/meta"] = np.array([height, width, reverse_z, y_offset], np.int32)
        arrays[name + "/ks"] = np.array([k for n, k in KB_RUNS if n == name], np.int32)
        if init is not None:
            arrays[name + "/init_depth"], arrays[name + "/init_pair"] = init
    tmp = tmp_path_factory.mktemp("raster_ref_reference")
    src, dst = str(tmp / "cases.npz"), str(tmp / "reference.npz")
    np.savez(src, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_CHILD, src, dst], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )

    @functools.lru_cache(maxsize=None)
    def result():
        out, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, out
        return dict(np.load(dst))

    try:
        yield result
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture
def reference(_reference_child):
    return _reference_child()


# --- frames --------------------------------------------------------------

def _small(make, **kw):
    dev, build, config, env = make(device="cpu", **kw)
    state = build(0.3)
    return dev, state, fit_caps(dev, state, config, env), env


@functools.lru_cache(maxsize=None)
def _frame_inputs(scene):
    if scene == "headline":
        return _small(headline_scene, width=128, height=64)
    if scene == "clip_blend":
        return _small(clip_blend_scene, width=128, height=64, stacks=16)
    return _small(all_passes_scene, width=128, height=64, stacks=16, lod_screen_height=64)


@pytest.mark.parametrize("scene", ["headline", "clip_blend", "all_passes"])
def test_ref_frame_equals_auto_frame(scene):
    """The same frame with raster="ref" and raster="auto" (the binned
    raster) at 128x64, after fit_caps: byte for byte, with every pass of
    the scene engaged, and the same stats but for pairs_needed (the
    brute-force raster bins nothing: 0)."""
    dev, state, config, env = _frame_inputs(scene)
    img_a, stats_a = port_frame.render_frame_stats(dev, state, config, env)
    img_r, stats_r = port_frame.render_frame_stats(
        dev, state, dataclasses.replace(config, raster="ref"), env)
    stats_a, stats_r = port_frame.stats_to_host(stats_a), port_frame.stats_to_host(stats_r)
    assert torch.equal(img_a, img_r)
    assert stats_r.pop("pairs_needed") == 0 and stats_a.pop("pairs_needed") > 0
    assert stats_a == stats_r
    if scene != "headline":
        assert min(stats_r["clip_layers_needed"], stats_r["blend_layers_needed"]) >= 1
    if scene == "all_passes":
        assert stats_r["particle_layers_needed"] >= 1
        lines_off = port_frame.render_frame(
            dev, state, dataclasses.replace(config, raster="ref", enable_lines=False), env)
        assert not torch.equal(lines_off, img_r)


# --- the rasters ---------------------------------------------------------

def _init(init):
    return None if init is None else VisibilityBuffer(*map(torch.from_numpy, init))


@pytest.mark.parametrize("name", ["hero", "hero-forward-z", "hero-band-init", "stack",
                                  "stack-forward-z", "heavy"])
def test_rasterize_ref_matches_reference(reference, name):
    """depth and pair (original row indices) bit for bit, walked from far
    or from an init buffer, over the whole frame or a band at y_offset."""
    tri, width, height, reverse_z, y_offset, init = _cases()[name]
    vis = rasterize_ref(tri, height, width, reverse_z=reverse_z, init=_init(init),
                        y_offset=y_offset)
    assert vis.depth.dtype == torch.float32 and vis.pair.dtype == torch.int32
    assert np.array_equal(reference[name + "/pair"], vis.pair.numpy())
    assert np.array_equal(reference[name + "/depth"], vis.depth.numpy())
    covered = (vis.pair >= 0) if init is None else (vis.pair != torch.from_numpy(init[1]))
    assert 0.02 < float(covered.float().mean()) < 1.0
    # the chunk size changes nothing
    other = rasterize_ref(tri, height, width, reverse_z=reverse_z, init=_init(init),
                          y_offset=y_offset, chunk=5)
    assert torch.equal(other.depth, vis.depth) and torch.equal(other.pair, vis.pair)


@pytest.mark.parametrize("run", KB_RUNS, ids=[f"{n}:{k}" for n, k in KB_RUNS])
def test_rasterize_kbuffer_ref_matches_reference(reference, run):
    """Every depth plane, pair plane (original row indices) and the layers
    count bit for bit; the stack holds more fragments than K = 1 or 4, and
    K = 16 holds all 12 of them."""
    name, k = run
    tri, width, height, reverse_z, y_offset, init = _cases()[name]
    floor = None if init is None else torch.from_numpy(init[0])
    kb, layers = rasterize_kbuffer_ref(tri, height, width, k=k, reverse_z=reverse_z,
                                       depth_floor=floor, y_offset=y_offset)
    key = f"{name}:{k}"
    assert np.array_equal(reference[key + "/pair"], kb.pair.numpy())
    assert np.array_equal(reference[key + "/depth"], kb.depth.numpy())
    assert np.array_equal(reference[key + "/layers"], layers.numpy())
    assert bool((kb.pair[0] >= 0).any())
    if name == "stack":
        assert int(layers.max()) == 12
        assert bool((kb.pair[min(k, 12) - 1] >= 0).any())


def test_in_process_gap():
    """In this process the reference's rasterize_ref runs with FMA
    contraction. On the hero at 160x96 its pair plane still equals the
    port's, and its depths differ from the port's by up to 45 ulp (held at
    64), as the interpret-mode tile kernel's do (tests/test_torch_raster.py)."""
    tri, width, height, reverse_z, _, _ = _cases()["hero"]
    assert int(tri.valid.sum()) < tri.valid.shape[0]
    ref_tri = ref_raster.TriangleSetup(*[jnp.asarray(getattr(tri, f).numpy())
                                         for f in tri._fields])
    ref = ref_raster.rasterize_ref(ref_tri, height, width, reverse_z=reverse_z)
    vis = rasterize_ref(tri, height, width, reverse_z=reverse_z)
    assert np.array_equal(np.asarray(ref.pair), vis.pair.numpy())
    ulp = np.abs(np.asarray(ref.depth).view(np.int32).astype(np.int64)
                 - vis.depth.numpy().view(np.int32).astype(np.int64))
    assert 0 < ulp.max() <= 64, ulp.max()


def test_empty_visibility_and_insert_order_match_reference():
    """empty_visibility in both z directions; a K-layer raster of no rows
    is empty with no layers."""
    for reverse_z in (True, False):
        ref = ref_raster.empty_visibility(7, 5, reverse_z)
        port = empty_visibility(7, 5, reverse_z, "cpu")
        assert np.array_equal(np.asarray(ref.depth), port.depth.numpy())
        assert np.array_equal(np.asarray(ref.pair), port.pair.numpy())
    tri, width, height, *_ = _cases()["stack"]
    none = tri._replace(valid=torch.zeros_like(tri.valid))
    kb, layers = rasterize_kbuffer_ref(none, height, width, k=4)
    ref_kb = ref_kbuffer.empty_kbuffer(4, height, width)
    assert np.array_equal(np.asarray(ref_kb.pair), kb.pair.numpy())
    assert np.array_equal(np.asarray(ref_kb.depth), kb.depth.numpy())
    assert int(layers.max()) == 0

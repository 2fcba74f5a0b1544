"""Binning and the visibility raster of the port against the reference,
fed the SAME JAX setup rows: bins bit for bit, and the port's plain raster
bit for bit in depth and pair against the reference's Pallas kernel in
interpret mode (rasterize_pallas_sorted(..., interpret=True)), run without
FMA contraction (see the raster_cases fixture). The CUDA kernel against the
plain raster (bit for bit in both) runs only where there is a card."""

import functools
import os
import subprocess
import sys
import textwrap
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_box_glb
from superconductor_tpu import Camera, Scene, Similarity, make_uniforms
from superconductor_tpu.assets.models import load_model
from superconductor_tpu.math3d import quat_from_axis_angle
from superconductor_tpu.ops import binning as ref_binning
from superconductor_tpu.ops.geometry import geometry_pass, make_draw_list
from superconductor_tpu.render import frame as ref_frame
from superconductor_tpu.render.draws import build_frame_state
from superconductor_tpu_torch.bench_raster import raster_bound
from superconductor_tpu_torch.ops import raster as raster_mod
from superconductor_tpu_torch.ops.binning import bin_triangles, gather_sorted_setup
from superconductor_tpu_torch.ops.geometry import TriangleSetup
from superconductor_tpu_torch.ops.raster import rasterize_sorted, rasterize_sorted_plain
from superconductor_tpu_torch.ops.raster_ref import VisibilityBuffer
from superconductor_tpu_torch.scenes import headline_host, heavy_tile_setup, quad_stack_setup
from test_torch_host import REF_HOST

# The test workers share the CPU: torch's default of a thread per core in
# each of them oversubscribes it many times over.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _to_port(tri) -> TriangleSetup:
    return TriangleSetup(*[torch.from_numpy(np.array(x)) for x in tri])


def _box_tri(box_glb, width, height):
    """tests/test_raster_pallas.py's box scene."""
    scene = Scene()
    model = load_model(scene, box_glb, name="box")
    uniforms = make_uniforms(Camera(position=np.array([0.6, 0.8, 2.0], np.float32)),
                             width, height)
    sim = Similarity(rotation=quat_from_axis_angle([0, 1, 0], 0.6))
    prim = model.primitives[0]
    lod = prim.lods[0]
    draws = make_draw_list(
        sim.to_array()[None], np.array([lod.first_index // 3]),
        np.array([lod.index_count // 3]), first_vertex=np.array([lod.first_vertex]),
        vertex_count=np.array([lod.vertex_count]), material=np.array([prim.material]),
    )
    dev = scene.device_arrays()
    tri, _ = geometry_pass(
        draws, dev["indices"], dev["positions"], dev["normals"], dev["uvs"],
        dev["lightmap_uvs"], dev["tri_material"], dev["materials"],
        jnp.asarray(uniforms.view_proj[0]), width, height, t_cap=16,
    )
    return tri


@functools.lru_cache(maxsize=None)
def _hero_tri(width, height, angle):
    scene, model, uniforms, _env, config = headline_host(width, height, host=REF_HOST)
    rcfg = ref_frame.RenderConfig(**{**asdict(config), "raster": "pallas"})
    sim = Similarity(rotation=quat_from_axis_angle([0, 1, 0], angle))
    state = build_frame_state(scene, [(model, sim)], uniforms)

    @jax.jit
    def geometry(dev, state):
        tri, _ = ref_frame._merged_geometry(dev, state, state.uniforms["view_proj"][0], rcfg)
        return tri

    return geometry(scene.device_arrays(), state)


_ref_bins = jax.jit(ref_binning.bin_triangles, static_argnums=(1, 2, 3),
                    static_argnames=("y_offset",))


def _check_bins(tri, width, height, p_cap, y_offset=0, rb=None):
    """The port's bins of the same setup rows equal the reference's (rb,
    computed here unless given) field for field, dtype included."""
    if rb is None:
        rb = _ref_bins(tri, width, height, p_cap, y_offset=y_offset)
    pb = bin_triangles(_to_port(tri), width, height, p_cap, y_offset=y_offset)
    for f in rb._fields:
        a, b = np.asarray(getattr(rb, f)), getattr(pb, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    return rb, pb


def _cases() -> dict:
    """name -> raster inputs: tests/test_raster_pallas.py's box scene at its
    two sizes, the hero at 256x128 with reverse and forward z, and a band
    [40, 104) of the hero over an init buffer (random depths below the
    geometry's and random pair ids, made with numpy)."""
    box = make_box_glb()
    hero = _hero_tri(256, 128, 0.3)
    rng = np.random.default_rng(11)
    init = (
        rng.uniform(0.0, 0.03, size=(64, 256)).astype(np.float32),
        rng.integers(-1, 500, size=(64, 256)).astype(np.int32),
    )
    return {
        "box-64x128": dict(tri=_box_tri(box, 128, 64), width=128, height=64,
                           p_cap=128, min_covered=0.05),
        "box-96x256": dict(tri=_box_tri(box, 256, 96), width=256, height=96,
                           p_cap=128, min_covered=0.05),
        "hero-reverse-z": dict(tri=hero, width=256, height=128, p_cap=1 << 13,
                               min_covered=0.2),
        "hero-forward-z": dict(tri=hero, width=256, height=128, p_cap=1 << 13,
                               reverse_z=False, min_covered=0.2),
        "hero-band-init": dict(tri=hero, width=256, height=64, p_cap=1 << 13,
                               y_offset=40, init=init, min_covered=0.5),
    }


CASES = ("box-64x128", "box-96x256", "hero-reverse-z", "hero-forward-z", "hero-band-init")

_REFERENCE_CHILD = textwrap.dedent(
    """
    import sys
    import jax.numpy as jnp
    import numpy as np
    from superconductor_tpu.ops.raster_pallas import rasterize_pallas_sorted
    from superconductor_tpu.ops.raster_ref import VisibilityBuffer

    cases = np.load(sys.argv[1])
    out = {}
    for name in sorted({k.split("/")[0] for k in cases.files}):
        def get(key):
            return jnp.asarray(cases[name + "/" + key])
        height, width, reverse_z, y_offset = (int(v) for v in cases[name + "/meta"])
        init = None
        if name + "/init_depth" in cases.files:
            init = VisibilityBuffer(get("init_depth"), get("init_pair"))
        vis = rasterize_pallas_sorted(
            get("setup"), get("tile_start"), get("tile_count"), height, width,
            reverse_z=bool(reverse_z), init=init, interpret=True, y_offset=y_offset,
        )
        out[name + "/depth"] = np.asarray(vis.depth)
        out[name + "/pair"] = np.asarray(vis.pair)
    np.savez(sys.argv[2], **out)
    """
)


@pytest.fixture(scope="module")
def raster_cases(tmp_path_factory):
    """Every case binned by the reference, and the reference's
    interpret-mode kernel run on its tile-sorted setup rows in ONE child
    process whose XLA CPU backend is capped at AVX. XLA's CPU backend always
    allows FMA contraction, so in this process the interpret-mode kernel
    fuses the multiply-adds of its edge and z sums and its depths move by a
    few ulp (up to 40 on the hero). Without FMA instructions every product
    and sum rounds on its own: the arithmetic of the CUDA kernel (built
    -fmad=false) and of the plain version, so the comparison is bit for bit."""
    cases = _cases()
    arrays, bins = {}, {}
    for name in CASES:
        c = cases[name]
        y_offset = c.get("y_offset", 0)
        rb = _ref_bins(c["tri"], c["width"], c["height"], c["p_cap"], y_offset=y_offset)
        bins[name] = rb
        arrays[name + "/setup"] = np.asarray(ref_binning.gather_sorted_setup(c["tri"], rb))
        arrays[name + "/tile_start"] = np.asarray(rb.tile_start)
        arrays[name + "/tile_count"] = np.asarray(rb.tile_count)
        arrays[name + "/meta"] = np.array(
            [c["height"], c["width"], c.get("reverse_z", True), y_offset], np.int32
        )
        if "init" in c:
            arrays[name + "/init_depth"], arrays[name + "/init_pair"] = c["init"]
    tmp = tmp_path_factory.mktemp("raster_reference")
    src, dst = str(tmp / "cases.npz"), str(tmp / "reference.npz")
    np.savez(src, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE_CHILD, src, dst], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    ref = np.load(dst)
    return {
        name: (cases[name], bins[name], arrays[name + "/setup"],
               ref[name + "/depth"], ref[name + "/pair"])
        for name in CASES
    }


@pytest.mark.parametrize("name", CASES)
def test_bins_bit_exact(raster_cases, name):
    c, rb, ref_setup, _, _ = raster_cases[name]
    _, pb = _check_bins(c["tri"], c["width"], c["height"], c["p_cap"],
                        c.get("y_offset", 0), rb=rb)
    assert np.array_equal(ref_setup, gather_sorted_setup(_to_port(c["tri"]), pb).numpy())


@pytest.mark.parametrize("name", CASES)
def test_plain_raster_matches_interpret_kernel(raster_cases, name):
    """depth and pair bit for bit against rasterize_pallas_sorted(...,
    interpret=True) on the same setup rows; the CPU wrapper takes the plain
    version."""
    c, rb, ref_setup, ref_depth, ref_pair = raster_cases[name]
    init = None
    if "init" in c:
        init = VisibilityBuffer(torch.from_numpy(c["init"][0]), torch.from_numpy(c["init"][1]))
    args = (torch.tensor(ref_setup), torch.tensor(np.asarray(rb.tile_start)),
            torch.tensor(np.asarray(rb.tile_count)), c["height"], c["width"])
    kw = dict(reverse_z=c.get("reverse_z", True), init=init, y_offset=c.get("y_offset", 0))
    pv = rasterize_sorted_plain(*args, **kw)
    assert np.array_equal(ref_pair, pv.pair.numpy())
    assert np.array_equal(ref_depth, pv.depth.numpy())
    assert (pv.pair >= 0).float().mean() > c["min_covered"]
    wv = rasterize_sorted(*args, **kw)
    assert torch.equal(wv.pair, pv.pair) and torch.equal(wv.depth, pv.depth)


def test_bins_bit_exact_with_overflow():
    """p_cap below the need: both truncate the same pairs and report the
    full need."""
    tri = _hero_tri(256, 128, 0.3)
    rb, pb = _check_bins(tri, 256, 128, p_cap=1024)
    assert int(pb.num_pairs) > 1024


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the raster kernel has no CPU mode)")
    dev = torch.device("cuda")
    tri = _to_port(_hero_tri(256, 128, 0.3))
    tri = TriangleSetup(*[x.to(dev) for x in tri])
    for y0, h in ((0, 128), (40, 64)):
        bins = bin_triangles(tri, 256, h, 1 << 13, y_offset=y0)
        s = gather_sorted_setup(tri, bins).contiguous()
        args = (s, bins.tile_start, bins.tile_count, h, 256)
        before = rasterize_sorted.LAUNCHES
        k = rasterize_sorted(*args, y_offset=y0)
        assert rasterize_sorted.LAUNCHES == before + 1
        p = rasterize_sorted_plain(*args, y_offset=y0)
        torch.cuda.synchronize()
        assert torch.equal(k.pair, p.pair) and torch.equal(k.depth, p.depth)


def _split_merge(sorted_setup, tile_start, tile_count, height, width, parts,
                 reverse_z, init, start):
    """The CUDA kernel's split-and-merge rule written with the plain
    version: each tile's rows cut into `parts` contiguous parts, each part
    rasterized alone from `start` ("far", or "inf": -inf under reverse-z,
    +inf otherwise, as the kernel starts them), then merged part by part in
    order from init (or far) under the strict depth test."""
    far = 0.0 if reverse_z else 1.0
    if init is None:
        depth = torch.full((height, width), far)
        pair = torch.full((height, width), -1, dtype=torch.int32)
    else:
        depth, pair = init.depth.clone(), init.pair.clone()
    beyond = float("-inf") if reverse_z else float("inf")
    part_init = None
    if start == "inf":
        part_init = VisibilityBuffer(torch.full((height, width), beyond),
                                     torch.full((height, width), -1, dtype=torch.int32))
    count = tile_count.to(torch.int64)
    for s in range(parts):
        lo = tile_start + (count * s // parts).to(torch.int32)
        n = (count * (s + 1) // parts - count * s // parts).to(torch.int32)
        part = rasterize_sorted_plain(sorted_setup, lo, n, height, width,
                                      reverse_z=reverse_z, init=part_init)
        take = part.depth > depth if reverse_z else part.depth < depth
        depth = torch.where(take, part.depth, depth)
        pair = torch.where(take, part.pair, pair)
    return VisibilityBuffer(depth=depth, pair=pair)


@functools.lru_cache(maxsize=None)
def _split_cases(name, reverse_z):
    """(sorted setup, bins, height, width) of the port's own setups: the
    hero at 256x128 (z reversed for forward-z), the 12-quad stack with its
    equal-z copies, and one tile of 2,044 rows holding every triangle
    twice, the copies ~1,000 rows apart."""
    if name == "hero":
        tri = _to_port(_hero_tri(256, 128, 0.3))
        if not reverse_z:
            setup = tri.setup.clone()
            setup[:, 9:12] = setup[:, 12:15] - setup[:, 9:12]  # z -> w - z
            tri = tri._replace(setup=setup)
        width, height, p_cap = 256, 128, 1 << 13
    elif name == "stack":
        tri = quad_stack_setup(200, 80, "cpu", reverse_z=reverse_z)
        width, height, p_cap = 200, 80, 512
    else:
        tri = heavy_tile_setup(320, 96, "cpu", reverse_z=reverse_z)
        width, height, p_cap = 320, 96, 4096
    bins = bin_triangles(tri, width, height, p_cap)
    return gather_sorted_setup(tri, bins).contiguous(), bins, height, width


@pytest.mark.parametrize("start", ["far", "inf"])
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("reverse_z", [True, False])
@pytest.mark.parametrize("name", ["hero", "stack", "heavy"])
def test_split_merge_equals_whole_walk(name, reverse_z, with_init, start):
    """Splitting every tile into S in {2, 3, 8} contiguous parts and merging
    them in order gives the whole walk bit for bit: ties across part
    boundaries keep the earlier part, and init keeps its ties."""
    sorted_setup, bins, height, width = _split_cases(name, reverse_z)
    args = (sorted_setup, bins.tile_start, bins.tile_count, height, width)
    init = None
    if with_init:
        whole = rasterize_sorted_plain(*args, reverse_z=reverse_z)
        rng = np.random.default_rng(12)
        keep = torch.from_numpy(rng.uniform(size=(height, width)) < 0.5)
        init = VisibilityBuffer(
            depth=torch.where(keep, whole.depth, torch.full_like(whole.depth, 0.5)),
            pair=torch.from_numpy(rng.integers(-1, 5000, size=(height, width)).astype(np.int32)),
        )
    ref = rasterize_sorted_plain(*args, reverse_z=reverse_z, init=init)
    assert (ref.pair >= 0).any()
    for parts in (2, 3, 8):
        got = _split_merge(*args, parts, reverse_z, init, start)
        assert torch.equal(got.depth, ref.depth) and torch.equal(got.pair, ref.pair), parts


def test_split_cases_have_ties_across_parts():
    """The stack's three equal quads and the heavy tile's copies fall into
    different parts of an 8-way split, and the later copy never wins."""
    sorted_setup, bins, height, width = _split_cases("heavy", True)
    t = int(torch.argmax(bins.tile_count))
    n = int(bins.tile_count[t])
    assert n >= 2000
    vis = rasterize_sorted_plain(sorted_setup, bins.tile_start, bins.tile_count, height, width)
    ntx = -(-width // 128)
    ty, tx = divmod(t, ntx)
    tile_pair = vis.pair[ty * 32:(ty + 1) * 32, tx * 128:(tx + 1) * 128]
    assert (ty, tx) == (1, 1)
    assert 0 <= int(tile_pair.max()) < int(bins.tile_start[t]) + n // 2
    sorted_setup, bins, height, width = _split_cases("stack", True)
    rows = sorted_setup[bins.tile_start[0]:bins.tile_start[0] + bins.tile_count[0]]
    assert torch.equal(rows[0], rows[2]) and torch.equal(rows[0], rows[4])


def test_raster_bound_counts_box_pixels_in_tiles():
    """bench_raster.raster_bound charges the edge operations only at the
    pixels of each row's tile that its triangle's bounding box covers
    inside the band: against a loop over the pairs, in a band with a
    y_offset, at far less than every pixel of every row's tile."""
    tri = _to_port(_hero_tri(256, 128, 0.3))
    y0, h, w, px_bytes = 40, 64, 256, 8
    bins = bin_triangles(tri, w, h, 1 << 13, y_offset=y0)
    pairs = int(bins.tile_count.sum())
    ntx, ntiles = 2, 2 * 2
    edge_px = 0
    for p in range(pairs):
        tile, t = int(bins.tile_of_pair[p]), int(bins.order[p])
        bx0, by0, bx1, by1 = (int(v) for v in tri.bbox[t])
        tx, ty = tile % ntx * 128, tile // ntx * 32 + y0
        cols = min(bx1, tx + 127, w - 1) - max(bx0, tx) + 1
        rows = min(by1, ty + 31, y0 + h - 1) - max(by0, ty) + 1
        edge_px += max(cols, 0) * max(rows, 0)
    assert 0 < edge_px < pairs * 4096 // 4
    t_bytes = (pairs * 64 + ntiles * 8 + w * h * px_bytes) / 3.35e12 * 1e3
    t_ops = 12 * edge_px / 67e12 * 1e3
    bound_ms, bound_by, got_pairs = raster_bound(tri.bbox, bins, w, h, px_bytes, y0)
    assert got_pairs == pairs
    assert bound_ms == pytest.approx(max(t_bytes, t_ops), rel=1e-12)
    assert bound_by == ("operations" if t_ops >= t_bytes else "bytes")


def test_raster_bound_charges_floor_bytes_in_busy_tiles():
    """raster_bound charges `busy_px_bytes` (a k-buffer's depth floor) only
    at the pixels of tiles holding a row, the ragged last column and row of
    tiles cut to the band: against a loop over the tiles, on a band where
    some tiles are empty."""
    from superconductor_tpu_torch.bench_raster import kbuffer_px_bytes

    tri = _to_port(_hero_tri(256, 128, 0.3))
    y0, h, w = 8, 120, 300
    bins = bin_triangles(tri, w, h, 1 << 13, y_offset=y0)
    ntx, nty = 3, 4
    busy_px = 0
    for t in range(ntx * nty):
        if int(bins.tile_count[t]) > 0:
            ty, tx = divmod(t, ntx)
            busy_px += min(128, w - tx * 128) * min(32, h - ty * 32)
    assert 0 < busy_px < w * h
    pixel_bytes = kbuffer_px_bytes(4, False, True)
    assert pixel_bytes == {"px_bytes": 20, "busy_px_bytes": 4}
    bound_ms, _, pairs = raster_bound(tri.bbox, bins, w, h, y_offset=y0, **pixel_bytes)
    without, _, _ = raster_bound(tri.bbox, bins, w, h, 20, y0)
    t_bytes = (pairs * 64 + ntx * nty * 8 + w * h * 20 + busy_px * 4) / 3.35e12 * 1e3
    assert bound_ms == pytest.approx(max(t_bytes, without), rel=1e-12)
    assert bound_ms > without


def test_build_freshness_follows_headers(tmp_path):
    """build_kernels rebuilds a library older than its source or than any
    csrc/*.cuh beside it (both kernels include raster_common.cuh): checked
    through raster.is_fresh on files with set mtimes, without nvcc."""
    src, header, lib = tmp_path / "k.cu", tmp_path / "common.cuh", tmp_path / "libk.so"
    src.write_text("")
    header.write_text("")
    assert not raster_mod.is_fresh(str(src), str(lib))  # never built
    lib.write_bytes(b"")
    for path, mtime in ((src, 100), (header, 100), (lib, 200)):
        os.utime(path, (mtime, mtime))
    assert raster_mod.is_fresh(str(src), str(lib))
    os.utime(header, (300, 300))  # an edited header
    assert not raster_mod.is_fresh(str(src), str(lib))
    os.utime(lib, (400, 400))
    assert raster_mod.is_fresh(str(src), str(lib))
    os.utime(src, (500, 500))  # an edited source
    assert not raster_mod.is_fresh(str(src), str(lib))
    for source, _library in raster_mod.KERNELS.values():
        with open(source) as f:
            assert '#include "raster_common.cuh"' in f.read()


@pytest.mark.gpu
def test_kernel_split_matches_plain_on_card(monkeypatch):
    """The cluster split on the card: every cluster size and split
    threshold, both z directions, with and without init, on the heavy tile
    and the stack, bit for bit against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the raster kernel has no CPU mode)")
    dev = torch.device("cuda")
    for name in ("heavy", "stack"):
        for reverse_z in (True, False):
            sorted_setup, bins, height, width = _split_cases(name, reverse_z)
            args = (sorted_setup.to(dev), bins.tile_start.to(dev), bins.tile_count.to(dev),
                    height, width)
            plain = rasterize_sorted_plain(*args, reverse_z=reverse_z)
            init = VisibilityBuffer(depth=(plain.depth * 0.999).contiguous(),
                                    pair=torch.arange(height * width, dtype=torch.int32,
                                                      device=dev).reshape(height, width))
            plain_init = rasterize_sorted_plain(*args, reverse_z=reverse_z, init=init)
            for cluster in (1, 2, 4, 8):
                for min_part_rows in (1, 32):
                    monkeypatch.setattr(raster_mod, "RASTER_CLUSTER", cluster)
                    monkeypatch.setattr(raster_mod, "RASTER_MIN_PART_ROWS", min_part_rows)
                    k = rasterize_sorted(*args, reverse_z=reverse_z)
                    ki = rasterize_sorted(*args, reverse_z=reverse_z, init=init)
                    torch.cuda.synchronize()
                    assert torch.equal(k.pair, plain.pair) and torch.equal(k.depth, plain.depth)
                    assert torch.equal(ki.pair, plain_init.pair)
                    assert torch.equal(ki.depth, plain_init.depth)

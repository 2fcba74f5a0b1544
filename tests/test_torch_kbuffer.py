"""The port's k-buffer raster against the reference's, fed the SAME
tile-sorted setup rows: kbuffer_sorted_plain bit for bit in every depth
plane, pair plane and the layers count against kbuffer_pallas_sorted(...,
interpret=True) run without FMA contraction (see the kbuffer_cases
fixture); kbuffer_insert bit for bit against the reference's, and so a
numpy model of the deep kernel's (K > 16) sorted insert. The CUDA
kernel's split of heavy tiles into parts merged by top K is modelled with
the plain version (bit for bit against the whole walk), for the templates'
merge and the deep kernel's. The CUDA kernel against the plain version
(bit for bit) runs only where there is a card."""

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
from superconductor_tpu_torch.math3d import Similarity, quat_from_axis_angle
from superconductor_tpu_torch.ops import raster_kbuffer as port_kbuffer
from superconductor_tpu_torch.ops.binning import bin_triangles, gather_sorted_setup
from superconductor_tpu_torch.ops.geometry import TriangleSetup
from superconductor_tpu_torch.ops import raster as raster_mod
from superconductor_tpu_torch.ops.raster import (
    KBUFFER_DEEP_MAX_K,
    KBUFFER_KS,
    kbuffer_smem_bytes,
    kbuffer_sorted,
    kbuffer_sorted_global,
    rasterize_sorted_plain,
)
from superconductor_tpu_torch.render.draws import build_frame_state
from superconductor_tpu_torch.render.frame import _merged_setup_for_view, _merged_vertex_stage
from superconductor_tpu_torch.scene.upload import scene_to_torch
from superconductor_tpu_torch.scenes import headline_host, heavy_tile_setup, quad_stack_setup

# The test workers share the CPU: torch's default of a thread per core in
# each of them oversubscribes it many times over.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _hero_setup(width, height):
    """The port's setup rows of the hero at 0.3 rad (bit-exact with the
    eager reference, tests/test_torch_geometry.py), every triangle."""
    scene, model, uniforms, _env, config = headline_host(width, height)
    state = build_frame_state(
        scene, [(model, Similarity(rotation=quat_from_axis_angle([0, 1, 0], 0.3)))], uniforms,
        device="cpu",
    )
    stages, _ = _merged_vertex_stage(scene_to_torch(scene, "cpu"), state, config)
    return _merged_setup_for_view(stages, state.uniforms["view_proj"][0], config)


def _cases() -> dict:
    """name -> k-buffer raster inputs: the quad stack (reverse and forward
    z, no floor), and a band [40, 104) of the hero over a floor of random
    depths (numpy seed) around its own surface depths, with y_offset 40."""
    rng = np.random.default_rng(22)
    band_floor = rng.uniform(0.02, 0.06, size=(64, 256)).astype(np.float32)
    return {
        "stack": dict(tri=quad_stack_setup(200, 80, "cpu"), width=200, height=80, p_cap=512),
        "stack-forward-z": dict(tri=quad_stack_setup(200, 80, "cpu", reverse_z=False), width=200,
                                height=80, p_cap=512, reverse_z=False),
        "deep-stack": dict(tri=quad_stack_setup(200, 80, "cpu", extra=21), width=200, height=80,
                           p_cap=1024),
        "hero-band-floor": dict(tri=_hero_setup(256, 128), width=256, height=64,
                                p_cap=1 << 13, y_offset=40, floor=band_floor),
    }


# (case, k, want_depth)
RUNS = (
    ("stack", 1, True), ("stack", 2, True), ("stack", 4, True), ("stack", 8, True),
    ("stack", 4, False), ("stack-forward-z", 2, True), ("stack-forward-z", 8, False),
    ("hero-band-floor", 1, True), ("hero-band-floor", 4, True),
    ("hero-band-floor", 8, False), ("stack", 16, True), ("hero-band-floor", 16, False),
    # K off the kernel's templates: below 16 and past it
    ("stack", 3, True), ("hero-band-floor", 3, False), ("deep-stack", 3, True),
    ("deep-stack", 24, True), ("deep-stack", 32, False), ("hero-band-floor", 24, True),
    # the smallest deep K
    ("deep-stack", 17, True), ("deep-stack", 17, False),
)

_REFERENCE_CHILD = textwrap.dedent(
    """
    import sys
    import jax.numpy as jnp
    import numpy as np
    from superconductor_tpu.ops.raster_pallas import kbuffer_pallas_sorted

    cases = np.load(sys.argv[1])
    runs = [r.split(":") for r in sys.argv[3].split(",")]
    out = {}
    for name, k, want in runs:
        def get(key):
            return jnp.asarray(cases[name + "/" + key])
        height, width, reverse_z, y_offset = (int(v) for v in cases[name + "/meta"])
        floor = get("floor") if name + "/floor" in cases.files else None
        kb, layers = kbuffer_pallas_sorted(
            get("setup"), get("tile_start"), get("tile_count"), height, width,
            k=int(k), reverse_z=bool(reverse_z), depth_floor=floor, interpret=True,
            y_offset=y_offset, want_depth=want == "1",
        )
        run = f"{name}:{k}:{want}"
        if kb.depth is not None:
            out[run + "/depth"] = np.asarray(kb.depth)
        out[run + "/pair"] = np.asarray(kb.pair)
        out[run + "/layers"] = np.asarray(layers)
    np.savez(sys.argv[2], **out)
    """
)


def _run_key(name, k, want_depth):
    return f"{name}:{k}:{int(want_depth)}"


@pytest.fixture(scope="module")
def kbuffer_cases(tmp_path_factory):
    """Every case binned by the port (bins are bit-exact with the
    reference's, tests/test_torch_raster.py), and the reference's
    interpret-mode k-buffer kernel run on the same tile-sorted rows in ONE
    child process whose XLA CPU backend is capped at AVX: XLA's CPU backend
    always allows FMA contraction, and only without FMA instructions does
    every product and sum round on its own, as in the plain version and in
    the CUDA kernel (built -fmad=false)."""
    cases = _cases()
    arrays, inputs = {}, {}
    for name, c in cases.items():
        y_offset = c.get("y_offset", 0)
        bins = bin_triangles(c["tri"], c["width"], c["height"], c["p_cap"], y_offset=y_offset)
        assert int(bins.num_pairs) <= c["p_cap"]
        setup = gather_sorted_setup(c["tri"], bins)
        floor = None if c.get("floor") is None else torch.from_numpy(c["floor"])
        inputs[name] = (setup, bins.tile_start, bins.tile_count, floor)
        arrays[name + "/setup"] = setup.numpy()
        arrays[name + "/tile_start"] = bins.tile_start.numpy()
        arrays[name + "/tile_count"] = bins.tile_count.numpy()
        arrays[name + "/meta"] = np.array(
            [c["height"], c["width"], c.get("reverse_z", True), y_offset], np.int32
        )
        if floor is not None:
            arrays[name + "/floor"] = c["floor"]
    tmp = tmp_path_factory.mktemp("kbuffer_reference")
    src, dst = str(tmp / "cases.npz"), str(tmp / "reference.npz")
    np.savez(src, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
    env.pop("PYTHONPATH", None)
    runs = ",".join(_run_key(*r) for r in RUNS)
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE_CHILD, src, dst, runs], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    return cases, inputs, dict(np.load(dst))


@pytest.mark.parametrize("run", RUNS, ids=[_run_key(*r) for r in RUNS])
def test_plain_kbuffer_matches_interpret_kernel(kbuffer_cases, run):
    """Every depth plane (when wanted), pair plane and layers bit for bit
    against kbuffer_pallas_sorted(..., interpret=True); the CPU wrapper
    takes the plain version."""
    cases, inputs, ref = kbuffer_cases
    name, k, want_depth = run
    c = cases[name]
    setup, tile_start, tile_count, floor = inputs[name]
    args = (setup, tile_start, tile_count, c["height"], c["width"])
    kw = dict(k=k, reverse_z=c.get("reverse_z", True), depth_floor=floor,
              y_offset=c.get("y_offset", 0), want_depth=want_depth)
    kb, layers = port_kbuffer.kbuffer_sorted_plain(*args, **kw)
    key = _run_key(*run)
    assert np.array_equal(ref[key + "/pair"], kb.pair.numpy())
    assert np.array_equal(ref[key + "/layers"], layers.numpy())
    if want_depth:
        assert np.array_equal(ref[key + "/depth"], kb.depth.numpy())
    else:
        assert kb.depth is None and key + "/depth" not in ref
    assert bool((kb.pair[0] >= 0).any())
    most = {"stack": 12, "stack-forward-z": 12, "deep-stack": 24}.get(name)
    if most and k < most:  # more fragments than K
        assert int(layers.max()) > k and bool((kb.pair[k - 1] >= 0).any())
    elif most:  # every fragment held, the slots past them empty
        assert int(layers.max()) == most
        assert bool((kb.pair[most - 1] >= 0).any()) and not bool((kb.pair[most:] >= 0).any())
    kb_w, layers_w = kbuffer_sorted(*args, **kw)
    assert torch.equal(kb_w.pair, kb.pair) and torch.equal(layers_w, layers)


def test_stack_holds_equal_depth_ties():
    """The stack case really ties: the three copies of one quad give equal
    z at a pixel, and the k-buffer holds the later sorted position first."""
    tri = quad_stack_setup(200, 80, "cpu")
    bins = bin_triangles(tri, 200, 80, 512)
    kb, _ = port_kbuffer.kbuffer_sorted_plain(
        gather_sorted_setup(tri, bins), bins.tile_start, bins.tile_count, 200, 80, k=8
    )
    d, p = kb.depth, kb.pair
    tie = (d[:-1] == d[1:]) & (p[1:] >= 0)
    assert bool(tie.any())
    assert bool((p[:-1][tie] > p[1:][tie]).all())


def _deep_insert(zs, ps, layers, z, p, reverse_z):
    """One accepted fragment (z, p) into one pixel's list zs, ps (K,) as
    csrc/kbuffer.cu kbuffer_deep_kernel inserts it, in place -> the new
    count: a full list whose last slot is strictly nearer drops it;
    otherwise, from the end of the held slots (the last one, which falls
    off, when full), every slot not strictly nearer moves back one and the
    fragment lands in the gap."""
    k = zs.shape[0]

    def nearer(a, b):
        return a > b if reverse_z else a < b

    held = min(layers, k)
    if held == k and nearer(zs[k - 1], z):
        return layers + 1
    i = held if held < k else k - 1
    while i > 0 and not nearer(zs[i - 1], z):
        zs[i], ps[i] = zs[i - 1], ps[i - 1]
        i -= 1
    zs[i], ps[i] = z, p
    return layers + 1


# (reverse_z, K); the ids of the K = 4 cases are those of reverse_z alone
INSERT_CASES = [(True, 4), (False, 4), (True, 17), (False, 24), (True, 64), (False, 64)]


@pytest.mark.parametrize(
    "reverse_z,k", INSERT_CASES,
    ids=[str(rz) if k == 4 else f"{rz}-k{k}" for rz, k in INSERT_CASES],
)
def test_kbuffer_insert_matches_reference(reverse_z, k):
    """K + 16 (at least twelve) inserts of random candidates (depths drawn
    from a small set, so ties are common, -0.0 among them under reverse z;
    random accept masks; numpy seed) into K slots: depth and pair bit for
    bit after every insert, and so the deep kernel's insert (_deep_insert)
    at every pixel, held with the count of accepted fragments past K."""
    rng = np.random.default_rng(23 + reverse_z + k)
    h, w = 6, 5
    ref = ref_kbuffer.empty_kbuffer(k, h, w, reverse_z)
    port = port_kbuffer.empty_kbuffer(k, h, w, reverse_z, device="cpu")
    far = np.float32(0.0 if reverse_z else 1.0)
    deep_z = np.full((h, w, k), far, np.float32)
    deep_p = np.full((h, w, k), -1, np.int32)
    deep_n = np.zeros((h, w), np.int64)
    values = np.float32([0.1, 0.25, 0.25, 0.5, 0.75] + ([-0.0] if reverse_z else []))
    for i in range(max(12, k + 16)):
        z = rng.choice(values, size=(h, w))
        accept = rng.uniform(size=(h, w)) < (0.7 if k == 4 else 0.9)
        pair = np.full((h, w), i, np.int32)
        ref = ref_kbuffer.kbuffer_insert(ref, jnp.asarray(z), jnp.asarray(pair),
                                         jnp.asarray(accept), reverse_z)
        port = port_kbuffer.kbuffer_insert(port, torch.from_numpy(z), torch.from_numpy(pair),
                                           torch.from_numpy(accept), reverse_z)
        assert np.array_equal(np.asarray(ref.depth), port.depth.numpy())
        assert np.array_equal(np.asarray(ref.pair), port.pair.numpy())
        if k > 16:
            for y, x in zip(*np.nonzero(accept)):
                deep_n[y, x] = _deep_insert(deep_z[y, x], deep_p[y, x], deep_n[y, x],
                                            z[y, x], i, reverse_z)
            ref_depth = np.asarray(ref.depth)
            assert np.array_equal(np.moveaxis(deep_p, -1, 0), np.asarray(ref.pair))
            assert np.array_equal(np.moveaxis(deep_z, -1, 0).view(np.int32),
                                  ref_depth.view(np.int32))
    assert (port.pair.numpy() >= 0).all()
    if k > 16:
        assert (deep_n > k).all()


def test_kbuffer_sorted_rejects_what_the_kernel_does_not_take():
    """Off the CPU the wrapper launches the kernel or raises: an unknown
    device type raises before any build. The global-memory kernel's
    wrapper has no plain version at all: a CPU tensor raises too."""
    setup = torch.zeros((4, 16), device="meta")
    ts = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kbuffer_sorted(setup, ts, ts, 32, 128, k=4)
    for dev in ("meta", "cpu"):
        setup = torch.zeros((4, 16), device=dev)
        ts = torch.zeros((1,), dtype=torch.int32, device=dev)
        with pytest.raises(ValueError):
            kbuffer_sorted_global(setup, ts, ts, 32, 128, k=24)


@pytest.mark.gpu
def test_kbuffer_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the k-buffer kernel has no CPU mode)")
    dev = torch.device("cuda")
    cases = _cases()
    for name, c in cases.items():
        tri = TriangleSetup(*[x.to(dev) for x in c["tri"]])
        y0 = c.get("y_offset", 0)
        bins = bin_triangles(tri, c["width"], c["height"], c["p_cap"], y_offset=y0)
        s = gather_sorted_setup(tri, bins).contiguous()
        floor = None if c.get("floor") is None else torch.from_numpy(c["floor"]).to(dev)
        args = (s, bins.tile_start, bins.tile_count, c["height"], c["width"])
        for k in KBUFFER_KS:
            for want in (True, False):
                kw = dict(k=k, reverse_z=c.get("reverse_z", True), depth_floor=floor,
                          y_offset=y0, want_depth=want)
                before = kbuffer_sorted.LAUNCHES
                kb, layers = kbuffer_sorted(*args, **kw)
                assert kbuffer_sorted.LAUNCHES == before + 1
                pkb, players = port_kbuffer.kbuffer_sorted_plain(*args, **kw)
                torch.cuda.synchronize()
                assert torch.equal(kb.pair, pkb.pair) and torch.equal(layers, players)
                if want:
                    assert torch.equal(kb.depth, pkb.depth)
    # the opaque raster's depth as a floor, as the frame passes it
    tri = TriangleSetup(*[x.to(dev) for x in _hero_setup(256, 128)])
    bins = bin_triangles(tri, 256, 128, 1 << 13)
    s = gather_sorted_setup(tri, bins).contiguous()
    vis = rasterize_sorted_plain(s, bins.tile_start, bins.tile_count, 128, 256)
    floor = vis.depth * 0.98
    kb, layers = kbuffer_sorted(s, bins.tile_start, bins.tile_count, 128, 256, k=2,
                                depth_floor=floor)
    pkb, players = port_kbuffer.kbuffer_sorted_plain(
        s, bins.tile_start, bins.tile_count, 128, 256, k=2, depth_floor=floor
    )
    assert torch.equal(kb.depth, pkb.depth) and torch.equal(kb.pair, pkb.pair)
    assert torch.equal(layers, players)


@functools.lru_cache(maxsize=None)
def _split_case(name, reverse_z):
    """(sorted setup, bins, height, width) of the 12-quad stack (equal-z
    copies, up to 12 layers), of the 73-quad stack (up to 73 layers, tiles
    of 72-146 rows), or of one tile of 2,044 rows holding every small
    triangle twice, the exact copies ~1,000 rows apart."""
    if name == "stack":
        tri, width, height, p_cap = quad_stack_setup(200, 80, "cpu", reverse_z=reverse_z), 200, 80, 512
    elif name == "deep-stack":
        tri = quad_stack_setup(200, 80, "cpu", reverse_z=reverse_z, extra=70)
        width, height, p_cap = 200, 80, 2048
    else:
        tri, width, height, p_cap = heavy_tile_setup(320, 96, "cpu", reverse_z=reverse_z), 320, 96, 4096
    bins = bin_triangles(tri, width, height, p_cap)
    return gather_sorted_setup(tri, bins).contiguous(), bins, height, width


def _split_floor(height, width, reverse_z):
    """A floor of random depths (numpy seed) that rejects some fragments of
    both split cases."""
    f = np.random.default_rng(24).uniform(0.15, 0.5, size=(height, width))
    return torch.from_numpy((f if reverse_z else 1.0 - f).astype(np.float32))


def _merge_insert(depth, pair, z, p, reverse_z):
    """The kernel's merge step: insert fragment (z, p) (H, W) (p < 0: none)
    into the sorted lists depth, pair (K, H, W) behind every held slot that
    is strictly nearer or, at an equal depth (-0.0 == 0.0), holds a larger
    sorted position; the last slot falls off."""
    k = depth.shape[0]
    nearer = depth > z[None] if reverse_z else depth < z[None]
    ahead = (pair >= 0) & (nearer | ((depth == z[None]) & (pair > p[None])))
    rank = torch.where(p >= 0, ahead.sum(dim=0), k)
    out_d, out_p = [], []
    for i in range(k):
        prev = max(i - 1, 0)
        out_d.append(torch.where(rank == i, z, torch.where(rank < i, depth[prev], depth[i])))
        out_p.append(torch.where(rank == i, p, torch.where(rank < i, pair[prev], pair[i])))
    return torch.stack(out_d), torch.stack(out_p)


@functools.lru_cache(maxsize=None)
def _part_lists(name, reverse_z, with_floor, parts, k=8):
    """Every tile's rows of a split case cut into `parts` contiguous parts
    as the kernel cuts them, each part walked alone by the plain version
    from empty slots under the same floor, at K = k -> [(depth, pair,
    layers)] by part. A part's top K is the first K slots of its top k
    (its list is sorted by the total order), so every K up to k takes
    these."""
    sorted_setup, bins, height, width = _split_case(name, reverse_z)
    floor = _split_floor(height, width, reverse_z) if with_floor else None
    count = bins.tile_count.to(torch.int64)
    out = []
    for s in range(parts):
        lo = bins.tile_start + (count * s // parts).to(torch.int32)
        n = (count * (s + 1) // parts - count * s // parts).to(torch.int32)
        kb, layers = port_kbuffer.kbuffer_sorted_plain(
            sorted_setup, lo, n, height, width, k=k, reverse_z=reverse_z, depth_floor=floor
        )
        out.append((kb.depth, kb.pair, layers))
    return out


def _merge_parts(part_lists, k, reverse_z):
    """The CUDA kernel's merge: part 0's first K slots as they are, then
    every later part's entries inserted by _merge_insert; layers is the sum
    of the parts' counts."""
    depth, pair, layers = part_lists[0]
    depth, pair = depth[:k], pair[:k]
    for part_depth, part_pair, part_layers in part_lists[1:]:
        layers = layers + part_layers
        for j in range(k):
            depth, pair = _merge_insert(depth, pair, part_depth[j], part_pair[j], reverse_z)
    return depth, pair, layers


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("with_floor", [False, True])
@pytest.mark.parametrize("reverse_z", [True, False])
@pytest.mark.parametrize("name", ["stack", "heavy"])
def test_kbuffer_split_merge_equals_whole_walk(name, reverse_z, with_floor, k):
    """Splitting every tile into 2, 3 and 8 contiguous parts and merging
    the parts' top-K lists by the kernel's rule gives the whole walk's
    depth, pair and layers planes bit for bit: equal-z copies in different
    parts keep the later sorted position first, and layers exceeds K."""
    sorted_setup, bins, height, width = _split_case(name, reverse_z)
    floor = _split_floor(height, width, reverse_z) if with_floor else None
    args = (sorted_setup, bins.tile_start, bins.tile_count, height, width)
    whole, whole_layers = port_kbuffer.kbuffer_sorted_plain(
        *args, k=k, reverse_z=reverse_z, depth_floor=floor
    )
    assert bool((whole.pair[k - 1] >= 0).any()) and int(whole_layers.max()) > k
    for parts in (2, 3, 8):
        depth, pair, layers = _merge_parts(_part_lists(name, reverse_z, with_floor, parts), k,
                                           reverse_z)
        assert torch.equal(depth, whole.depth), parts
        assert torch.equal(pair, whole.pair), parts
        assert torch.equal(layers, whole_layers), parts


def _deep_merge(part_lists, k, reverse_z, base=0):
    """csrc/kbuffer.cu kbuffer_deep_kernel's merge of a split band, in
    numpy: part `base`'s sorted list (its first min(layers, K) slots) takes
    every other part's, in order, each merged in from the back: the next
    slot down takes whichever of the two lists' last unmerged entries is
    behind the other (the other nearer or, at an equal depth, -0.0 == 0.0,
    holding the larger sorted position), slots past K drop, and once the
    other list is used up the rest stand where they are. Empty slots hold
    far / -1; layers is the sum of the parts' counts."""
    far = np.float32(0.0 if reverse_z else 1.0)

    def nearer(a, b):
        return a > b if reverse_z else a < b

    def held_list(i):
        d, p, n = part_lists[i]
        return d.numpy()[:k].copy(), p.numpy()[:k].copy(), np.minimum(n.numpy(), k)

    az, ap, na = held_list(base)
    count = sum(n.numpy() for _, _, n in part_lists)
    for s in range(len(part_lists)):
        if s == base:
            continue
        bz, bp, nb = held_list(s)
        src_z, src_p = az.copy(), ap.copy()  # the kernel's writes never pass an unread slot
        ia, ib = na - 1, nb - 1
        out = ia + ib + 1
        na = np.minimum(out + 1, k)
        while bool((ib >= 0).any()):
            live = ib >= 0
            a_z = np.take_along_axis(src_z, np.clip(ia, 0, None)[None], 0)[0]
            a_p = np.take_along_axis(src_p, np.clip(ia, 0, None)[None], 0)[0]
            b_z = np.take_along_axis(bz, np.clip(ib, 0, None)[None], 0)[0]
            b_p = np.take_along_axis(bp, np.clip(ib, 0, None)[None], 0)[0]
            a_behind = (ia >= 0) & (nearer(b_z, a_z) | ((b_z == a_z) & (b_p > a_p)))
            z, p = np.where(a_behind, a_z, b_z), np.where(a_behind, a_p, b_p)
            put = live & (out < k)
            ys, xs = np.nonzero(put)
            az[out[put], ys, xs], ap[out[put], ys, xs] = z[put], p[put]
            ia = ia - (live & a_behind)
            ib = ib - (live & ~a_behind)
            out = out - live
    empty = np.arange(k)[:, None, None] >= na[None]
    az, ap = np.where(empty, far, az), np.where(empty, -1, ap)
    return torch.from_numpy(az), torch.from_numpy(ap.astype(np.int32)), torch.from_numpy(count)


@pytest.mark.parametrize("k", [17, 24, 64])
@pytest.mark.parametrize("with_floor", [False, True])
@pytest.mark.parametrize("reverse_z", [True, False])
@pytest.mark.parametrize("name", ["deep-stack", "heavy"])
def test_kbuffer_deep_split_merge_equals_whole_walk(name, reverse_z, with_floor, k):
    """The deep kernel's split (K > 16): every tile cut into 2, 3 and 8
    contiguous parts, the parts' lists merged by _deep_merge into the first
    part's and into the last's, gives the whole walk's depth, pair and
    layers planes bit for bit: on the 73-quad stack more fragments than K
    at a pixel, on the heavy tile equal-z copies in different parts."""
    sorted_setup, bins, height, width = _split_case(name, reverse_z)
    floor = _split_floor(height, width, reverse_z) if with_floor else None
    whole, whole_layers = port_kbuffer.kbuffer_sorted_plain(
        sorted_setup, bins.tile_start, bins.tile_count, height, width, k=k,
        reverse_z=reverse_z, depth_floor=floor,
    )
    if name == "deep-stack":
        assert bool((whole.pair[k - 1] >= 0).any()) and int(whole_layers.max()) > k
    for parts in (2, 3, 8):
        for base in (0, parts - 1):
            depth, pair, layers = _deep_merge(
                _part_lists(name, reverse_z, with_floor, parts, k=64), k, reverse_z, base
            )
            assert torch.equal(depth.view(torch.int32), whole.depth.view(torch.int32)), parts
            assert torch.equal(pair, whole.pair), parts
            assert torch.equal(layers, whole_layers), parts


def test_kbuffer_split_case_ties_across_parts():
    """In the heavy tile, cut in two as the kernel cuts it, some pixel holds
    two equal-z fragments from different parts (the later one first) and
    more accepted fragments than K."""
    sorted_setup, bins, height, width = _split_case("heavy", True)
    t = int(torch.argmax(bins.tile_count))
    half = int(bins.tile_start[t]) + int(bins.tile_count[t]) // 2
    kb, layers = port_kbuffer.kbuffer_sorted_plain(
        sorted_setup, bins.tile_start, bins.tile_count, height, width, k=2
    )
    d, p = kb.depth, kb.pair
    across = (d[0] == d[1]) & (p[1] >= 0) & ((p[0] >= half) != (p[1] >= half))
    assert bool(across.any())
    assert bool((p[0][across] > p[1][across]).all())
    assert bool((layers[across] > 2).any())


@pytest.mark.gpu
def test_kbuffer_kernel_split_matches_plain_on_card(monkeypatch):
    """The kernel's cluster split on the card: every cluster size and split
    threshold, on the heavy tile, the stack and the 73-quad stack, both z
    directions, with and without a floor, every template K and the deep
    kernel's K = 17, 24, 32, 64 and 128, with and without depth planes, bit
    for bit against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the k-buffer kernel has no CPU mode)")
    dev = torch.device("cuda")
    for name in ("heavy", "stack", "deep-stack"):
        for reverse_z in (True, False):
            sorted_setup, bins, height, width = _split_case(name, reverse_z)
            args = (sorted_setup.to(dev), bins.tile_start.to(dev), bins.tile_count.to(dev),
                    height, width)
            for floor in (None, _split_floor(height, width, reverse_z).to(dev)):
                for k in KBUFFER_KS + (17, 24, 32, 64, 128):
                    for want in (True, False):
                        kw = dict(k=k, reverse_z=reverse_z, depth_floor=floor, want_depth=want)
                        pkb, players = port_kbuffer.kbuffer_sorted_plain(*args, **kw)
                        for cluster in (1, 2, 4, 8):
                            for min_part_rows in (1, 32):
                                monkeypatch.setattr(raster_mod, "KBUFFER_CLUSTER", cluster)
                                monkeypatch.setattr(raster_mod, "KBUFFER_DEEP_CLUSTER", cluster)
                                monkeypatch.setattr(raster_mod, "KBUFFER_MIN_PART_ROWS",
                                                    min_part_rows)
                                kb, layers = kbuffer_sorted(*args, **kw)
                                torch.cuda.synchronize()
                                assert torch.equal(kb.pair, pkb.pair)
                                assert torch.equal(layers, players)
                                if want:
                                    assert torch.equal(kb.depth, pkb.depth)


@pytest.mark.gpu
def test_kbuffer_kernel_takes_every_k_on_card(monkeypatch):
    """K off the kernel's templates on the card: K = 3, 5 and 12 (the next
    template's first K planes) and K = 17, 24, 32, 64 and 128 (the deep
    kernel), at every cluster size, with and without depth planes, bit for
    bit against the plain version, on every case and on the heavy tile in
    both z directions under a floor; the 24-quad stack holds more than 16
    fragments at a pixel. Then: the deep kernel's largest K takes shared
    memory and the next does not; the global-memory kernel equals the deep
    kernel at K = 24, 32 and 64 and runs K = KBUFFER_DEEP_MAX_K + 1 (on the
    heavy tile, bit for bit); and a K = 64 call without depth planes
    allocates its pair planes and layers only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the k-buffer kernel has no CPU mode)")
    dev = torch.device("cuda")
    runs = []
    for name, c in _cases().items():
        tri = TriangleSetup(*[x.to(dev) for x in c["tri"]])
        y0 = c.get("y_offset", 0)
        bins = bin_triangles(tri, c["width"], c["height"], c["p_cap"], y_offset=y0)
        floor = None if c.get("floor") is None else torch.from_numpy(c["floor"]).to(dev)
        runs.append(((gather_sorted_setup(tri, bins).contiguous(), bins.tile_start,
                      bins.tile_count, c["height"], c["width"]),
                     dict(reverse_z=c.get("reverse_z", True), depth_floor=floor, y_offset=y0)))
    for reverse_z in (True, False):
        sorted_setup, bins, height, width = _split_case("heavy", reverse_z)
        runs.append(((sorted_setup.to(dev), bins.tile_start.to(dev), bins.tile_count.to(dev),
                      height, width),
                     dict(reverse_z=reverse_z,
                          depth_floor=_split_floor(height, width, reverse_z).to(dev))))
    deepest = 0
    for args, base in runs:
        for k in (3, 5, 12, 17, 24, 32, 64, 128):
            for want in (True, False):
                kw = dict(base, k=k, want_depth=want)
                pkb, players = port_kbuffer.kbuffer_sorted_plain(*args, **kw)
                deepest = max(deepest, int(players.max()))
                for cluster in (1, 2, 4, 8):
                    monkeypatch.setattr(raster_mod, "KBUFFER_CLUSTER", cluster)
                    monkeypatch.setattr(raster_mod, "KBUFFER_DEEP_CLUSTER", cluster)
                    before = kbuffer_sorted.LAUNCHES
                    kb, layers = kbuffer_sorted(*args, **kw)
                    torch.cuda.synchronize()
                    assert kbuffer_sorted.LAUNCHES == before + 1
                    assert kb.pair.shape == (k, args[3], args[4]) and kb.pair.is_contiguous()
                    assert torch.equal(kb.pair, pkb.pair), (k, cluster)
                    assert torch.equal(layers, players), (k, cluster)
                    if want:
                        assert torch.equal(kb.depth, pkb.depth), (k, cluster)
                    else:
                        assert kb.depth is None
    assert deepest > 16

    assert kbuffer_smem_bytes(KBUFFER_DEEP_MAX_K) > 0
    assert kbuffer_smem_bytes(KBUFFER_DEEP_MAX_K + 1) == -1
    args, base = runs[-1]
    for k in (24, 32, 64):
        kb, layers = kbuffer_sorted(*args, **base, k=k)
        gkb, glayers = kbuffer_sorted_global(*args, **base, k=k)
        torch.cuda.synchronize()
        assert torch.equal(kb.pair, gkb.pair) and torch.equal(kb.depth, gkb.depth)
        assert torch.equal(layers, glayers)
    k = KBUFFER_DEEP_MAX_K + 1
    pkb, players = port_kbuffer.kbuffer_sorted_plain(*args, **base, k=k, want_depth=False)
    kb, layers = kbuffer_sorted(*args, **base, k=k, want_depth=False)
    torch.cuda.synchronize()
    assert torch.equal(kb.pair, pkb.pair) and torch.equal(layers, players)

    # no depth planes at K = 64: the call's peak is its pair planes and
    # layers (and the allocator's rounding), not twice that
    height, width = 1080, 1920
    ts = torch.zeros((34 * 15,), dtype=torch.int32, device=dev)
    setup = torch.zeros((1, 16), dtype=torch.float32, device=dev)
    kbuffer_sorted(setup, ts, ts, height, width, k=64, want_depth=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    kb, layers = kbuffer_sorted(setup, ts, ts, height, width, k=64, want_depth=False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - before
    planes = 65 * height * width * 4
    assert planes <= peak < planes + (64 << 20), peak
    assert bool((kb.pair == -1).all()) and bool((layers == 0).all())

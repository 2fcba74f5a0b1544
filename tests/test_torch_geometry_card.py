"""The geometry stage's CUDA kernels (csrc/geometry.cu) against their plain
versions on the card, bit for bit: ops/geometry.py geometry_vertex_stage
and geometry_vertex_stage_merged (vertex_stage_kernel, its vertex and
triangle phases) and geometry_view_setup and geometry_view_setup_merged
(view_setup_kernel). This file imports no JAX: its tests run only where
there is a card (-m gpu) and skip elsewhere.

    python -m pytest -q -m gpu tests/test_torch_geometry_card.py

The cases also serve tests/test_torch_geometry_kernel.py, which holds the
wrappers' checks on the CPU:

* vertex stage: seeded draw lists (VERTEX_CASES) with invalid draws, zero
  counts, totals above and below the capacities, triangle corners outside
  their draw's vertex range (row_ok false), negative material and
  tri_material ids (torch's indexing counts them from the end), NaN, +-inf
  and -0 in the positions, normals and uvs, a NaN payload in the lightmap
  uvs (copied as it is), nonzero uv rotations, and for the skinned lists
  joint rows outside the palette (clamped), rows of zero weights (0 / 0,
  NaN), of -0 weights and of negative ones; a list with no valid draw;
  a list whose totals are far under its capacities (mostly padding) and
  one of more draws than a block has threads; each with and without an
  `out` of rows inside a larger table.
* merged lists (MERGED_CASES): a static list and an animated one into one
  table, among them an animated list with no valid draw, through both
  merged entries at both viewport flips.
* view setup (SETUP_CASES): the synthetic lists' stages under a
  perspective camera, and a crafted stage whose corners lie behind the eye
  (w <= 1e-6, w exactly 1e-6, w = 0, NaN), repeat a vertex (det == 0), lie
  off screen or face away, at 1920 x 1080 and at 61 x 37, each with
  flip_viewport off and on, with and without `out`.
* the frames' merged stages of the small hero, stereo and lit scenes.
* torch.sum's two 4-term reductions in skin_vertices, whose order on the
  card the kernel follows (sum4_contiguous and sum4_strided in
  csrc/geometry.cu).
"""

import ctypes
import itertools
import zlib

import numpy as np
import pytest
import torch

from superconductor_tpu_torch import math3d
from superconductor_tpu_torch.ops import geometry as port_geom
from superconductor_tpu_torch.ops.geometry import VertexStage, row_slice, setup_table
from superconductor_tpu_torch.render import camera as port_camera

torch.set_num_threads(2)

# name -> (skinned, lightmap uvs, t_cap, v_cap, every draw invalid, draws)
VERTEX_CASES = {
    "static": (False, True, 256, 300, False, 12),
    "static-no-lm": (False, False, 256, 300, False, 12),
    "static-cut": (False, True, 64, 50, False, 12),
    "static-roomy": (False, True, 1000, 1200, False, 12),
    "static-mostly-padding": (False, True, 4000, 5000, False, 12),
    "static-many-draws": (False, True, 8192, 12000, False, 300),
    "skinned": (True, False, 256, 300, False, 12),
    "skinned-cut": (True, False, 64, 50, False, 12),
    "skinned-no-valid-draw": (True, False, 64, 64, True, 12),
}
# name -> (the static list's VERTEX_CASES name, the animated list's); both
# lists take the static one's materials
MERGED_CASES = {
    "static+skinned": ("static", "skinned"),
    "roomy+no-valid-draw": ("static-roomy", "skinned-no-valid-draw"),
    "cut+no-valid-draw": ("static-cut", "skinned-no-valid-draw"),
    "padding+skinned-cut": ("static-mostly-padding", "skinned-cut"),
    "many-draws+skinned": ("static-many-draws", "skinned"),
}
# name -> (stage source: a VERTEX_CASES name or "crafted", width, height)
SETUP_CASES = {
    "static": ("static", 1920, 1080),
    "skinned": ("skinned", 1920, 1080),
    "static-roomy": ("static-roomy", 61, 37),
    "crafted": ("crafted", 1920, 1080),
    "crafted-small": ("crafted", 61, 37),
}
N_VERTS, N_TRIS, N_MATS, N_JOINTS = 600, 400, 5, 8
OUT_PAD = 3  # rows of the larger table ahead of an `out`'s rows


def _specials(rng, a: np.ndarray, k: int) -> np.ndarray:
    """a with NaN, +-inf and -0 at k random entries."""
    flat = a.reshape(-1).copy()
    at = rng.choice(flat.size, size=k, replace=False)
    flat[at] = rng.choice(np.array([np.nan, np.inf, -np.inf, -0.0], np.float32), size=k)
    return flat.reshape(a.shape)


def _quats(rng, n: int) -> np.ndarray:
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def vertex_args(case: str, device) -> dict:
    """geometry_vertex_stage's arguments by name for VERTEX_CASES[case]."""
    skinned, lm, t_cap, v_cap, no_valid, n_draws = VERTEX_CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    f32 = np.float32
    positions = _specials(rng, rng.normal(scale=2.0, size=(N_VERTS, 3)).astype(f32), 6)
    normals = _specials(rng, rng.normal(size=(N_VERTS, 3)).astype(f32), 6)
    uvs = _specials(rng, rng.uniform(-2.0, 3.0, size=(N_VERTS, 2)).astype(f32), 4)
    lm_uvs = rng.uniform(0.0, 1.0, size=(N_VERTS, 2)).astype(f32)
    lm_uvs[7, 0] = np.array([0x7FC00123], np.uint32).view(f32)[0]  # a NaN with a payload
    lm_uvs[8, 1] = -0.0
    indices = rng.integers(0, 80, size=N_TRIS * 3).astype(np.int32)
    sim8 = np.concatenate([rng.normal(size=(n_draws, 3)), rng.uniform(0.5, 2.0, (n_draws, 1)),
                           _quats(rng, n_draws)], axis=1).astype(f32)
    sim8[3, 3] = -1.5
    valid = rng.random(n_draws) < 0.75
    valid[0] = True
    if no_valid:
        valid[:] = False
    draws = port_geom.make_draw_list(
        sim8, rng.integers(0, N_TRIS - 50, n_draws), rng.integers(0, 50, n_draws),
        first_vertex=rng.integers(0, 20, n_draws), vertex_count=rng.integers(0, 80, n_draws),
        joints_offset=rng.integers(0, 6, n_draws), material=rng.integers(-N_MATS, N_MATS, n_draws),
        lightmapped=rng.random(n_draws) < 0.5, valid=valid, device=device)
    rotation = rng.uniform(-7.0, 7.0, N_MATS).astype(f32)
    rotation[0] = 0.0
    materials = {
        "uv_offset": torch.from_numpy(rng.normal(size=(N_MATS, 2)).astype(f32)).to(device),
        "uv_scale": torch.from_numpy(rng.normal(size=(N_MATS, 2)).astype(f32)).to(device),
        "uv_rotation": torch.from_numpy(rotation).to(device),
        "flags": torch.from_numpy(rng.integers(0, 8, N_MATS).astype(np.int32)).to(device),
    }
    args = dict(
        draws=draws, indices=torch.from_numpy(indices).to(device),
        positions=torch.from_numpy(positions).to(device),
        normals=torch.from_numpy(normals).to(device), uvs=torch.from_numpy(uvs).to(device),
        lm_uvs=torch.from_numpy(lm_uvs).to(device) if lm else None,
        tri_material=torch.from_numpy(
            rng.integers(-N_MATS, N_MATS, N_TRIS).astype(np.int32)).to(device),
        materials=materials, t_cap=t_cap, v_cap=v_cap, joint_palette=None, joint_indices=None,
        joint_weights=None, out=None)
    if skinned:
        palette = np.concatenate([rng.normal(size=(N_JOINTS, 3)),
                                  rng.uniform(0.5, 1.5, (N_JOINTS, 1)), _quats(rng, N_JOINTS)],
                                 axis=1).astype(f32)
        weights = rng.uniform(0.0, 1.0, size=(N_VERTS, 4)).astype(f32)
        weights[rng.choice(N_VERTS, 20, replace=False)] = 0.0  # 0 / 0
        weights[0] = 0.0  # the row every padding slot reads
        weights[1] = -0.0
        weights[2] = (-0.5, 0.25, 1.0, -0.125)
        weights[3, 2] = np.nan
        weights[4] = (1e-30, 3e7, -3e7, 1.0)  # the order of the sum shows
        args.update(
            joint_palette=torch.from_numpy(palette).to(device),
            joint_indices=torch.from_numpy(
                rng.integers(-2, N_JOINTS + 3, size=(N_VERTS, 4)).astype(np.int32)).to(device),
            joint_weights=torch.from_numpy(weights).to(device))
    return args


def merged_args(case: str, device) -> dict:
    """geometry_vertex_stage_merged's arguments by name for
    MERGED_CASES[case]: the two lists, the static one's materials, and an
    `out` of both lists' rows OUT_PAD.. of a larger table."""
    lists = []
    for name in MERGED_CASES[case]:
        a = vertex_args(name, device)
        lists.append(port_geom.VertexList(**{k: a[k] for k in port_geom.VertexList._fields}))
    materials = vertex_args(MERGED_CASES[case][0], device)["materials"]
    rows = sum(lst.t_cap for lst in lists)
    table = port_geom.attrs_table(rows + OUT_PAD + 5, device)
    return dict(lists=tuple(lists), materials=materials,
                out=row_slice(table, OUT_PAD, OUT_PAD + rows))


def per_list_plain(args: dict) -> tuple:
    """The merged entry's lists through geometry_vertex_stage_plain, each
    into its rows of a new `out` like args' -> (stages, the out)."""
    rows = args["out"].packed.shape[0]
    out = row_slice(port_geom.attrs_table(rows + OUT_PAD + 5, args["out"].packed.device),
                    OUT_PAD, OUT_PAD + rows)
    stages, at = [], 0
    for lst in args["lists"]:
        stages.append(port_geom.geometry_vertex_stage_plain(
            **lst._asdict(), materials=args["materials"],
            out=row_slice(out, at, at + lst.t_cap)))
        at += lst.t_cap
    return tuple(stages), out


def merged_setup_args(stages, flip: bool, width: int, height: int, device) -> dict:
    """geometry_view_setup_merged's arguments by name for `stages`, with an
    `out` of their rows OUT_PAD.. of a larger table."""
    rows = sum(stage.row3.shape[0] for stage in stages)
    return dict(stages=stages, view_proj=perspective(width, height).to(device), width=width,
                height=height, flip_viewport=flip,
                out=row_slice(setup_table(rows + OUT_PAD + 5, device), OUT_PAD, OUT_PAD + rows))


def with_out(args: dict, device) -> dict:
    """args with an `out` of rows OUT_PAD.. of a larger table."""
    t = args["t_cap"]
    table = port_geom.attrs_table(t + OUT_PAD + 5, device)
    return dict(args, out=row_slice(table, OUT_PAD, OUT_PAD + t))


def perspective(width: int, height: int) -> torch.Tensor:
    """A camera's view_proj (4, 4) f32 looking at the synthetic geometry."""
    cam = port_camera.Camera(position=np.array([1.0, 2.0, 6.0], np.float32))
    cam.rotation = math3d.mat3_to_quat(
        math3d.mat4_inverse(math3d.look_at(cam.position, [0.0, 0.0, 0.0]))[:3, :3])
    return torch.from_numpy(np.ascontiguousarray(
        port_camera.make_uniforms(cam, width, height).view_proj[0], np.float32))


def crafted_stage(device) -> VertexStage:
    """A VertexStage (no attrs) of 64 rows of w1 given directly as clip-like
    coordinates (with an identity view_proj they are the clip coordinates)
    and 200 triangles over them: corners behind the eye, exactly at w =
    1e-6, at w = 0 and NaN, repeated corners (det == 0), corners far off
    screen, both windings."""
    rng = np.random.default_rng(11)
    v = 64
    w1 = np.concatenate([rng.uniform(-1.5, 1.5, (v, 2)), rng.uniform(0.0, 1.0, (v, 1)),
                         rng.uniform(0.2, 3.0, (v, 1))], axis=1).astype(np.float32)
    w1[0:4, 3] = (-1.0, 0.0, np.float32(1e-6), 1e-7)
    w1[4] = np.nan
    w1[5, 0] = 60.0 * w1[5, 3]  # far right
    w1[6, 1] = -60.0 * w1[6, 3]  # far below
    w1[7, :2] = -0.0
    t = 200
    row3 = rng.integers(0, v, size=(t, 3)).astype(np.int32)
    row3[:20, 1] = row3[:20, 0]  # det == 0
    row3[20:40, 0] = rng.integers(0, 4, 20)  # a corner behind the eye
    row3[40:45] = (0, 1, 2)  # every corner behind
    row3[45:50, 0], row3[50:55, 0] = 5, 6
    row3[55:60, 0] = 4
    row3[60:80] = row3[60:80, ::-1]
    return VertexStage(
        w1=torch.from_numpy(w1).to(device), row3=torch.from_numpy(row3).to(device),
        pair_inst=torch.from_numpy(rng.integers(0, 9, t).astype(np.int32)).to(device),
        scene_tri=torch.from_numpy(rng.integers(0, 999, t).astype(np.int32)).to(device),
        pair_valid=torch.from_numpy(rng.random(t) < 0.8).to(device),
        double_sided=torch.from_numpy(rng.random(t) < 0.5).to(device),
        num_valid=torch.tensor(t, dtype=torch.int32).to(device), attrs=None)


def setup_args(case: str, flip: bool, device, stage_fn=None) -> dict:
    """geometry_view_setup's arguments by name for SETUP_CASES[case]; the
    synthetic lists' stages come from stage_fn(vertex args) (default the
    wrapper)."""
    source, width, height = SETUP_CASES[case]
    if source == "crafted":
        stage = crafted_stage(device)
        view_proj = torch.eye(4, dtype=torch.float32).to(device)
    else:
        stage = (stage_fn or port_geom.geometry_vertex_stage)(**vertex_args(source, device))
        view_proj = perspective(width, height).to(device)
    return dict(stage=stage, view_proj=view_proj, width=width, height=height,
                flip_viewport=flip, out=None)


def with_setup_out(args: dict, device) -> dict:
    t = args["stage"].row3.shape[0]
    return dict(args, out=row_slice(setup_table(t + OUT_PAD + 5, device), OUT_PAD, OUT_PAD + t))


def fields(x, prefix: str = "") -> list:
    """[(name, leaf)] of the leaves (tensors, arrays, None) of (nested)
    NamedTuples, tuples and lists."""
    if not isinstance(x, (tuple, list)):
        return [(prefix, x)]
    names = x._fields if hasattr(x, "_fields") else [str(i) for i in range(len(x))]
    out = []
    for name, v in zip(names, x):
        out += fields(v, f"{prefix}.{name}" if prefix else name)
    return out


def bit_equal(out, want) -> list:
    """The fields of two results that differ (f32 fields by their int32
    views, so that NaN payloads and signed zeros count)."""
    bad = []
    for (name, a), (_, b) in zip(fields(out), fields(want)):
        if a is None or b is None:
            if (a is None) != (b is None):
                bad.append(name)
            continue
        if a.shape != b.shape or a.dtype != b.dtype:
            bad.append(f"{name} {a.dtype} {tuple(a.shape)} vs {b.dtype} {tuple(b.shape)}")
            continue
        if b.dtype == torch.float32:
            a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
        n = int((a != b).sum())
        if n:
            bad.append(f"{name}: {n} of {b.numel()}")
    return bad


# --- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (csrc/geometry.cu has no CPU mode)")
    return torch.device("cuda", 0)


def _sum_candidates(x: torch.Tensor) -> dict:
    """name -> x's 4 terms (last dim) added in that order, each op rounded
    to f32 on the card: left folds and pairs of every permutation, with
    and without adding each term to 0 first."""
    out = {}
    for perm in itertools.permutations(range(4)):
        for zero in (False, True):
            t = [(0.0 + x[..., i]) if zero else x[..., i] for i in perm]
            z = "0+" if zero else ""
            out[f"{z}(({perm[0]}+{perm[1]})+{perm[2]})+{perm[3]}"] = ((t[0] + t[1]) + t[2]) + t[3]
            out[f"{z}({perm[0]}+{perm[1]})+({perm[2]}+{perm[3]})"] = (t[0] + t[1]) + (t[2] + t[3])
    return out


def _sum_rows(n: int, seed: int) -> np.ndarray:
    """(n, 4) terms whose sum depends on the order: wide exponents, signs,
    and rows of -0 (which 0 + -0 turns to +0) and NaN."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 4)) * 10.0 ** rng.integers(-8, 9, size=(n, 4))).astype(np.float32)
    x[::17] = -0.0
    x[5::23, 1] = np.nan
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 64, 1000, 4096, 65536, 131072])
def test_torch_sum_orders_on_card(n):
    """torch.sum over the contiguous 4 weights of an (N, 4) table adds (0 +
    x0 + 0 + x2) + (0 + x1 + 0 + x3), and over the strided joints of an
    (N, 4, 3) table ((0 + x0 + 0 + x1) + 0 + x2) + 0 + x3: the orders
    csrc/geometry.cu's sum4_contiguous and sum4_strided take."""
    dev = _card()
    x = torch.from_numpy(_sum_rows(n, n)).to(dev)
    got = torch.sum(x, dim=-1, keepdim=True)[:, 0]
    cands = _sum_candidates(x)
    match = [k for k, v in cands.items() if torch.equal(v.view(torch.int32), got.view(torch.int32))]
    assert "0+(0+2)+(1+3)" in match, f"contiguous: torch.sum matches {match}"

    y = torch.from_numpy(np.stack([_sum_rows(n, n + c) for c in range(3)], axis=2)).to(dev)
    got = torch.sum(y, dim=-2)  # (n, 3)
    cands = _sum_candidates(y.transpose(1, 2))
    match = [k for k, v in cands.items() if torch.equal(v.view(torch.int32), got.view(torch.int32))]
    assert "0+((0+1)+2)+3" in match, f"strided: torch.sum matches {match}"


@pytest.mark.gpu
@pytest.mark.parametrize("out", [False, True])
@pytest.mark.parametrize("case", sorted(VERTEX_CASES))
def test_vertex_stage_kernel_equals_plain_on_card(case, out):
    dev = _card()
    args = vertex_args(case, dev)
    if out:
        args = with_out(args, dev)
    before = port_geom.geometry_vertex_stage.LAUNCHES
    got = port_geom.geometry_vertex_stage(**args)
    torch.cuda.synchronize()
    assert port_geom.geometry_vertex_stage.LAUNCHES == before + 2  # the two phases
    if out:
        args = with_out(args, dev)
    want = port_geom.geometry_vertex_stage_plain(**args)
    assert not bit_equal(got, want), bit_equal(got, want)
    if case == "skinned-no-valid-draw":
        assert bool(torch.isnan(got.w1[:, 0]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("out", [False, True])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("case", sorted(SETUP_CASES))
def test_view_setup_kernel_equals_plain_on_card(case, flip, out):
    dev = _card()
    args = setup_args(case, flip, dev)
    if out:
        args = with_setup_out(args, dev)
    before = port_geom.geometry_view_setup.LAUNCHES
    got = port_geom.geometry_view_setup(**args)
    torch.cuda.synchronize()
    assert port_geom.geometry_view_setup.LAUNCHES == before + 1
    if out:
        args = with_setup_out(args, dev)
    want = port_geom.geometry_view_setup_plain(**args)
    assert not bit_equal(got, want), bit_equal(got, want)
    if case.startswith("crafted"):
        assert 0 < int(want.valid.sum()) < want.valid.shape[0]


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(MERGED_CASES))
def test_merged_vertex_stage_kernel_equals_plain_on_card(case):
    """Both lists in one vertex-phase and one triangle-phase launch, equal
    to each list's plain version written at its offset; the merged
    wrapper's LAUNCHES rise by 2, the per-list wrapper's by none."""
    dev = _card()
    args = merged_args(case, dev)
    before = (port_geom.geometry_vertex_stage_merged.LAUNCHES,
              port_geom.geometry_vertex_stage.LAUNCHES)
    got = port_geom.geometry_vertex_stage_merged(**args)
    torch.cuda.synchronize()
    assert (port_geom.geometry_vertex_stage_merged.LAUNCHES,
            port_geom.geometry_vertex_stage.LAUNCHES) == (before[0] + 2, before[1])
    want, want_out = per_list_plain(args)
    assert not bit_equal((got, args["out"]), (want, want_out)), \
        bit_equal((got, args["out"]), (want, want_out))
    plain = port_geom.geometry_vertex_stage_merged_plain(**merged_args(case, dev))
    assert not bit_equal(got, plain), bit_equal(got, plain)
    if MERGED_CASES[case][1] == "skinned-no-valid-draw":
        assert bool(torch.isnan(got[1].w1[:, 0]).all())
        assert int(got[1].num_valid) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("size", [(1920, 1080), (61, 37)])
@pytest.mark.parametrize("case", sorted(MERGED_CASES))
def test_merged_view_setup_kernel_equals_plain_on_card(case, size, flip):
    """Both stages' setup in one launch, equal to each stage's plain
    version written at its offset with num_valid their torch sum; the
    merged wrapper's LAUNCHES rise by 1, the per-list wrapper's by none."""
    dev = _card()
    stages = port_geom.geometry_vertex_stage_merged_plain(**merged_args(case, dev))
    args = merged_setup_args(stages, flip, *size, dev)
    before = (port_geom.geometry_view_setup_merged.LAUNCHES,
              port_geom.geometry_view_setup.LAUNCHES)
    got = port_geom.geometry_view_setup_merged(**args)
    torch.cuda.synchronize()
    assert (port_geom.geometry_view_setup_merged.LAUNCHES,
            port_geom.geometry_view_setup.LAUNCHES) == (before[0] + 1, before[1])
    want = port_geom.geometry_view_setup_merged_plain(**merged_setup_args(stages, flip, *size,
                                                                          dev))
    assert not bit_equal(got, want), bit_equal(got, want)
    assert int(got.num_valid) == int(stages[0].num_valid) + int(stages[1].num_valid)
    no_out = port_geom.geometry_view_setup_merged(**dict(args, out=None))
    assert not bit_equal(no_out, want), bit_equal(no_out, want)


@pytest.mark.gpu
def test_args_bytes_match_the_mirrors_on_card():
    """The library's structs of arguments take the bytes of their ctypes
    mirrors (sc_geometry_args_bytes)."""
    from superconductor_tpu_torch.ops.raster import _kernel_fn

    _card()
    sizes = [_kernel_fn("sc_geometry_args_bytes")(which) for which in range(4)]
    assert sizes == [ctypes.sizeof(m) for m in port_geom._MIRRORS]


def _scenes(dev) -> dict:
    from superconductor_tpu_torch.scenes import (
        LIT_PASSES_SMALL,
        STEREO_TINY,
        headline_scene,
        lit_passes_scene,
        stereo_animated_scene,
    )

    return {"hero": headline_scene(256, 128, dev),
            "stereo": stereo_animated_scene(device=dev, **STEREO_TINY),
            "lit": lit_passes_scene(device=dev, **LIT_PASSES_SMALL)}


@pytest.mark.gpu
def test_frame_stages_equal_plain_on_card(monkeypatch):
    """The frames' merged stages (both lists, every view) with the kernels
    and with the plain versions bound where the frame looks them up."""
    from superconductor_tpu_torch.render import frame as frame_mod

    dev = _card()
    for name, (tables, build, config, _env) in _scenes(dev).items():
        for pose in (0.0, 0.9):
            state = build(pose)
            before = (port_geom.geometry_vertex_stage_merged.LAUNCHES,
                      port_geom.geometry_view_setup_merged.LAUNCHES)
            stages, attrs = frame_mod._merged_vertex_stage(tables, state, config)
            tris = [frame_mod._merged_setup_for_view(stages, state.uniforms["view_proj"][v],
                                                     config) for v in range(config.num_views)]
            assert (port_geom.geometry_vertex_stage_merged.LAUNCHES,
                    port_geom.geometry_view_setup_merged.LAUNCHES) == (
                before[0] + 2, before[1] + config.num_views)
            with monkeypatch.context() as m:
                for kernel, bindings in frame_mod.GEOMETRY_PLAIN_VERSIONS.items():
                    for mod, fn, plain in bindings:
                        m.setattr(mod, fn, plain)
                stages_p, attrs_p = frame_mod._merged_vertex_stage(tables, state, config)
                tris_p = [frame_mod._merged_setup_for_view(
                    stages_p, state.uniforms["view_proj"][v], config)
                    for v in range(config.num_views)]
            torch.cuda.synchronize()
            bad = bit_equal((stages, attrs, tris), (stages_p, attrs_p, tris_p))
            assert not bad, (name, pose, bad)
            assert int(tris[0].valid.sum()) > 0, name


@pytest.mark.gpu
def test_card_calls_never_reach_the_plain_versions(monkeypatch):
    """A CUDA call launches the kernel: with the plain versions (and the
    chains under them) made to raise, the wrappers still answer."""
    dev = _card()

    def refuse(*_a, **_k):
        raise AssertionError("a CUDA call reached a plain version")

    for name in ("geometry_vertex_stage_plain", "geometry_view_setup_plain",
                 "geometry_vertex_stage_merged_plain", "geometry_view_setup_merged_plain",
                 "skin_vertices", "_uv_transform", "clip_transform", "_setup_from_clip",
                 "expand_draws", "expand_draw_vertices", "pack_attrs"):
        monkeypatch.setattr(port_geom, name, refuse)
    for case in ("static", "skinned"):
        stage = port_geom.geometry_vertex_stage(**with_out(vertex_args(case, dev), dev))
        port_geom.geometry_view_setup(stage, perspective(64, 32).to(dev), 64, 32)
    stages = port_geom.geometry_vertex_stage_merged(**merged_args("static+skinned", dev))
    port_geom.geometry_view_setup_merged(stages, perspective(64, 32).to(dev), 64, 32)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_wrappers_capture_into_a_graph():
    """Both wrappers in one CUDA graph (no host synchronisation, the
    view_proj read through its pointer): a replay after a new matrix is
    copied in equals the eager calls on it."""
    dev = _card()
    args = vertex_args("skinned", dev)
    view_proj = perspective(64, 32).to(dev)
    port_geom.geometry_vertex_stage(**args)  # builds and loads the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stage = port_geom.geometry_vertex_stage(**args)
        tri = port_geom.geometry_view_setup(stage, view_proj, 64, 32)
    view_proj.copy_(perspective(80, 40).to(dev))
    graph.replay()
    torch.cuda.synchronize()
    want_stage = port_geom.geometry_vertex_stage_plain(**args)
    want = port_geom.geometry_view_setup_plain(want_stage, view_proj, 64, 32)
    assert not bit_equal((stage, tri), (want_stage, want))


@pytest.mark.gpu
def test_merged_wrappers_capture_into_a_graph():
    """The merged wrappers' three launches in one CUDA graph: a replay
    after a new matrix is copied in equals the plain versions on it."""
    dev = _card()
    args = merged_args("static+skinned", dev)
    view_proj = perspective(64, 32).to(dev)
    port_geom.geometry_vertex_stage_merged(**args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stages = port_geom.geometry_vertex_stage_merged(**args)
        tri = port_geom.geometry_view_setup_merged(stages, view_proj, 64, 32)
    view_proj.copy_(perspective(80, 40).to(dev))
    graph.replay()
    torch.cuda.synchronize()
    want_stages = port_geom.geometry_vertex_stage_merged_plain(**merged_args("static+skinned",
                                                                             dev))
    want = port_geom.geometry_view_setup_merged_plain(want_stages, view_proj, 64, 32)
    assert not bit_equal((stages, tri), (want_stages, want))

"""The geometry stage's wrappers (ops/geometry.py geometry_vertex_stage and
geometry_view_setup, csrc/geometry.cu) on the CPU:

* the frame's merged stages (render/frame.py _merged_vertex_stage and
  _merged_setup_for_view), which write each draw list's rows into one
  merged table at its own offset, against the JAX package's, which
  concatenates them: every field bit for bit (by its int32 view) on the
  valid rows and NaN-equal on the padding, for the hero at two angles under
  two views and for a skinned tube;
* the plain versions with an `out` of rows inside a larger table equal to
  them without one;
* the merged entries' plain versions equal to each list's plain version
  written at its offset, num_valid the lists' sum;
* the wrappers raising, off the CPU, on what their kernels do not take
  (meta tensors stand in for a card's);
* the ctypes mirrors of csrc/geometry.cu's structs of arguments naming its
  fields in order, each 8 B;
* chip_smoke.py's bound of both kernels on a small list whose bytes are
  counted here by hand, and of a merged call as the sum of its lists'.

The kernels themselves run in tests/test_torch_geometry_card.py (-m gpu)."""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from superconductor_tpu.render import frame as ref_frame
from superconductor_tpu_torch.ops import geometry as port_geom
from superconductor_tpu_torch.render import frame as port_frame
from superconductor_tpu_torch.scene.upload import scene_to_torch
from test_torch_geometry import _ref_config, _skinned_geometry
from test_torch_geometry import _hero_states, hero  # noqa: F401  (a fixture)
from test_torch_geometry_card import (
    MERGED_CASES,
    SETUP_CASES,
    VERTEX_CASES,
    bit_equal,
    fields,
    merged_args,
    merged_setup_args,
    per_list_plain,
    setup_args,
    vertex_args,
    with_out,
    with_setup_out,
)

torch.set_num_threads(2)


def _field_arrays(tree) -> list:
    return [(name, None if t is None else np.asarray(t)) for name, t in fields(tree)]


def _assert_merged_equal(ref, port, valid: np.ndarray) -> None:
    """Every field of the reference's and the port's (stages, attrs,
    setups): bit for bit on the valid rows of the merged tables (all rows
    of the per-stage ones), NaN-equal everywhere."""
    r_fields, p_fields = _field_arrays(ref), _field_arrays(port)
    assert [n for n, _ in r_fields] == [n for n, _ in p_fields]
    t = valid.shape[0]
    for (name, a), (_, b) in zip(r_fields, p_fields):
        if a is None:
            assert b is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype)
        assert np.array_equal(a, b, equal_nan=True), name
        if a.dtype == np.float32 and a.ndim and a.shape[0] == t:
            assert np.array_equal(a[valid].view(np.int32), b[valid].view(np.int32)), name


def _merged_pair(dev, dev_t, ref_state, port_state, config, view_projs):
    """((stages, attrs, setups) of the reference, eager, op by op; and the
    port's), each view's setup of view_projs (numpy (4, 4) each)."""
    import jax.numpy as jnp

    rcfg = _ref_config(config)
    st_r, at_r = ref_frame._merged_vertex_stage(dev, ref_state, rcfg)
    tris_r = [ref_frame._merged_setup_for_view(st_r, jnp.asarray(m), rcfg) for m in view_projs]
    st_p, at_p = port_frame._merged_vertex_stage(dev_t, port_state, config)
    tris_p = [port_frame._merged_setup_for_view(st_p, torch.from_numpy(m), config)
              for m in view_projs]
    return (st_r, at_r, tris_r), (st_p, at_p, tris_p)


def _second_view(view_proj: np.ndarray) -> np.ndarray:
    """Another view of the same scene: the eye moved along x (a stereo
    pair's other eye)."""
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = -0.12
    return np.ascontiguousarray((view_proj @ shift).astype(np.float32))


@pytest.mark.parametrize("angle", [0.3, 2.2])
def test_merged_stages_match_reference_on_hero(hero, angle):  # noqa: F811
    config = hero[0][4]
    dev = hero[0][0].device_arrays()
    dev_t = scene_to_torch(hero[1][0], "cpu")
    ref_state, port_state = _hero_states(hero, angle)
    vp = np.asarray(ref_state.uniforms["view_proj"][0], np.float32)
    ref, port = _merged_pair(dev, dev_t, ref_state, port_state, config, [vp, _second_view(vp)])
    for tri_r, tri_p in zip(ref[2], port[2]):
        valid = np.asarray(tri_r.valid)
        assert valid.sum() > 1000
        _assert_merged_equal((ref[1], tri_r), (port[1], tri_p), valid)
    _assert_merged_equal(ref[0], port[0], np.ones(0, bool))
    # the merged attributes are views of the packed rows
    assert port[1].world_pos.data_ptr() == port[1].packed.data_ptr()
    assert port[0][1].attrs.packed.data_ptr() == port[1].packed[config.t_cap:].data_ptr()


def test_merged_stages_match_reference_on_skinned_tube():
    """The skinned tube (tests/test_torch_geometry.py), eager: its animated
    stage with its NaN-free skinning, merged behind the static one."""
    (st_r, at_r, tri_r), (st_p, at_p, tri_p) = _skinned_geometry(jit=False)
    valid = np.asarray(tri_r.valid)
    assert valid.sum() > 50
    _assert_merged_equal((at_r, tri_r), (at_p, tri_p), valid)
    _assert_merged_equal(st_r, st_p, np.ones(0, bool))


@pytest.mark.parametrize("case", sorted(VERTEX_CASES))
def test_vertex_stage_plain_into_out_equals_plain(case):
    args = vertex_args(case, "cpu")
    want = port_geom.geometry_vertex_stage_plain(**args)
    got = port_geom.geometry_vertex_stage(**with_out(args, "cpu"))
    assert not bit_equal(got, want), bit_equal(got, want)
    assert got.attrs.packed._base is not None  # rows of the larger table


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("case", sorted(SETUP_CASES))
def test_view_setup_plain_into_out_equals_plain(case, flip):
    args = setup_args(case, flip, "cpu")
    want = port_geom.geometry_view_setup_plain(**args)
    got = port_geom.geometry_view_setup(**with_setup_out(args, "cpu"))
    assert not bit_equal(got, want), bit_equal(got, want)


@pytest.mark.parametrize("case", sorted(MERGED_CASES))
def test_merged_vertex_stage_plain_equals_per_list_plain(case):
    """The merged entry (on CPU tensors, its plain version) equals each
    list's plain version written into its rows of the merged table."""
    args = merged_args(case, "cpu")
    got = port_geom.geometry_vertex_stage_merged(**args)
    want, want_out = per_list_plain(args)
    assert not bit_equal((got, args["out"]), (want, want_out)), \
        bit_equal((got, args["out"]), (want, want_out))
    t_s = args["lists"][0].t_cap
    assert got[1].attrs.packed.data_ptr() == args["out"].packed[t_s:].data_ptr()
    alone = port_geom.geometry_vertex_stage_merged_plain(args["lists"], args["materials"])
    assert not bit_equal(alone, want), bit_equal(alone, want)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("case", sorted(MERGED_CASES))
def test_merged_view_setup_plain_equals_per_list_plain(case, flip):
    """The merged setup (on CPU tensors, its plain version) equals each
    stage's plain setup written into its rows, num_valid their sum."""
    stages = port_geom.geometry_vertex_stage_merged_plain(**merged_args(case, "cpu"))
    args = merged_setup_args(stages, flip, 1920, 1080, "cpu")
    got = port_geom.geometry_view_setup_merged(**args)
    rows = [s.row3.shape[0] for s in stages]
    want = [port_geom.geometry_view_setup_plain(s, args["view_proj"], 1920, 1080, flip)
            for s in stages]
    for name in ("setup", "tri_id", "inst_id", "bbox", "valid"):
        parts = torch.split(getattr(got, name), rows)
        for part, w in zip(parts, want):
            assert not bit_equal(part, getattr(w, name)), (name, bit_equal(part, getattr(w, name)))
    assert got.num_valid.dtype == torch.int32
    assert int(got.num_valid) == int(stages[0].num_valid) + int(stages[1].num_valid)
    assert got.setup.data_ptr() == args["out"].setup.data_ptr()
    alone = port_geom.geometry_view_setup_merged_plain(stages, args["view_proj"], 1920, 1080, flip)
    assert not bit_equal(alone, got), bit_equal(alone, got)


# --- the wrappers' checks, off the CPU ---------------------------------------------

def _meta(x):
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    if isinstance(x, dict):
        return {k: _meta(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_meta(v) for v in x])
    if isinstance(x, tuple):
        return tuple(_meta(v) for v in x)
    return x


def _draws(a, **kw):
    return dict(a, draws=a["draws"]._replace(**kw))


def _mats(a, **kw):
    m = dict(a["materials"], **kw)
    return dict(a, materials={k: v for k, v in m.items() if v is not None})


def _out(a, **kw):
    return dict(a, out=a["out"]._replace(**kw))


def _meta_out(a):
    return dict(a, out=port_geom.attrs_table(a["t_cap"], "meta"))


VERTEX_FAULTS = {
    "positions-dtype": lambda a: dict(a, positions=a["positions"].double()),
    "positions-width": lambda a: dict(a, positions=a["positions"][:, :2]),
    "normals-strided": lambda a: dict(a, normals=a["normals"].t().contiguous().t()),
    "uvs-cpu": lambda a: dict(a, uvs=torch.zeros(a["uvs"].shape)),
    "uvs-empty": lambda a: dict(a, uvs=a["uvs"][:0]),
    "lm_uvs-width": lambda a: dict(a, lm_uvs=torch.zeros((5, 3), device="meta")),
    "indices-dtype": lambda a: dict(a, indices=a["indices"].long()),
    "tri_material-2d": lambda a: dict(a, tri_material=a["tri_material"][:, None]),
    "uv_rotation-missing": lambda a: _mats(a, uv_rotation=None),
    "flags-dtype": lambda a: _mats(a, flags=a["materials"]["flags"].float()),
    "sim8-width": lambda a: _draws(a, sim8=a["draws"].sim8[:, :7]),
    "valid-dtype": lambda a: _draws(a, valid=a["draws"].valid.int()),
    "draw-columns-unequal": lambda a: _draws(a, material=a["draws"].material[:-1]),
    "draws-empty": lambda a: dict(a, draws=type(a["draws"])(*[c[:0] for c in a["draws"]])),
    "draws-too-many": lambda a: dict(a, draws=type(a["draws"])(*[
        c[:1].expand((port_geom.MAX_DRAWS + 1,) + c.shape[1:]).contiguous()
        for c in a["draws"]])),
    "t_cap-0": lambda a: dict(a, t_cap=0, v_cap=8),
    "palette-alone": lambda a: dict(a, joint_palette=torch.zeros((4, 8), device="meta")),
    "out-packed-width": lambda a: _out(_meta_out(a), packed=torch.zeros(
        (a["t_cap"], 30), device="meta")),
    "out-packed-columns-strided": lambda a: _out(_meta_out(a), packed=torch.zeros(
        (32, a["t_cap"]), device="meta").t()),
    "out-packed-unaligned": lambda a: _out(_meta_out(a), packed=torch.zeros(
        (a["t_cap"] * 32 + 1,), device="meta")[1:].view(a["t_cap"], 32)),
    "out-lightmapped-dtype": lambda a: _out(_meta_out(a), lightmapped=torch.zeros(
        (a["t_cap"],), dtype=torch.uint8, device="meta")),
}
SKINNED_FAULTS = {
    "palette-dtype": lambda a: dict(a, joint_palette=a["joint_palette"].double()),
    "joint_indices-missing": lambda a: dict(a, joint_indices=None),
    "joint_weights-width": lambda a: dict(a, joint_weights=a["joint_weights"][:, :3]),
}


@pytest.mark.parametrize("fault", sorted(VERTEX_FAULTS) + sorted(SKINNED_FAULTS)
                         + ["none", "none-skinned", "none-out"])
def test_vertex_stage_wrapper_raises_off_the_cpu(fault):
    """Every input the kernel does not take raises, and a good one raises
    too, off CUDA (no plain path)."""
    skinned = fault in SKINNED_FAULTS or fault == "none-skinned"
    args = _meta(vertex_args("skinned" if skinned else "static", "cpu"))
    if fault == "none-out":
        args = _meta_out(args)
    elif fault in VERTEX_FAULTS:
        args = VERTEX_FAULTS[fault](args)
    elif fault in SKINNED_FAULTS:
        args = SKINNED_FAULTS[fault](args)
    with pytest.raises((ValueError, TypeError),
                       match="CUDA tensors" if fault.startswith("none") else None):
        port_geom.geometry_vertex_stage(**args)


def _lists(a, i, fault):
    """Merged arguments with VERTEX_FAULTS[fault] applied to list i."""
    lst = a["lists"][i]
    bad = fault(dict(lst._asdict(), materials=a["materials"], out=None))
    lists = list(a["lists"])
    lists[i] = port_geom.VertexList(**{k: bad[k] for k in port_geom.VertexList._fields})
    return dict(a, lists=tuple(lists), materials=bad["materials"])


MERGED_VERTEX_FAULTS = {
    "lists-empty": lambda a: dict(a, lists=()),
    "lists-three": lambda a: dict(a, lists=a["lists"] + a["lists"][:1]),
    "list-on-another-device": lambda a: dict(a, lists=(
        a["lists"][0], a["lists"][1]._replace(positions=torch.zeros((8, 3))))),
    "out-rows": lambda a: dict(a, out=port_geom.attrs_table(
        a["out"].packed.shape[0] - 1, "meta")),
    "second-positions-dtype": lambda a: _lists(a, 1, VERTEX_FAULTS["positions-dtype"]),
    "second-t_cap-0": lambda a: _lists(a, 1, VERTEX_FAULTS["t_cap-0"]),
    "second-draws-too-many": lambda a: _lists(a, 1, VERTEX_FAULTS["draws-too-many"]),
    "first-palette-alone": lambda a: _lists(a, 0, VERTEX_FAULTS["palette-alone"]),
    "second-joint_weights-width": lambda a: _lists(a, 1, SKINNED_FAULTS["joint_weights-width"]),
    "flags-dtype": lambda a: _lists(a, 0, VERTEX_FAULTS["flags-dtype"]),
    "caps-sum": lambda a: dict(a, lists=tuple(
        lst._replace(t_cap=2 ** 30, v_cap=2 ** 30 - 1) for lst in a["lists"]), out=None),
}


@pytest.mark.parametrize("fault", sorted(MERGED_VERTEX_FAULTS) + ["none", "none-no-out"])
def test_merged_vertex_stage_wrapper_raises_off_the_cpu(fault):
    """Every input the merged kernel does not take raises, and a good one
    raises too, off CUDA (no plain path)."""
    args = _meta(merged_args("static+skinned", "cpu"))
    args["out"] = port_geom.attrs_table(args["out"].packed.shape[0], "meta")
    if fault == "none-no-out":
        args["out"] = None
    elif fault in MERGED_VERTEX_FAULTS:
        args = MERGED_VERTEX_FAULTS[fault](args)
    with pytest.raises((ValueError, TypeError),
                       match="CUDA tensors" if fault.startswith("none") else None) as err:
        port_geom.geometry_vertex_stage_merged(**args)
    assert fault.startswith("none") or "runs on CUDA tensors" not in str(err.value)


def _stage(a, **kw):
    return dict(a, stage=a["stage"]._replace(**kw))


def _setup_out(a, **kw):
    t = a["stage"].row3.shape[0]
    return dict(a, out=port_geom.setup_table(t, "meta")._replace(**kw))


SETUP_FAULTS = {
    "row3-dtype": lambda a: _stage(a, row3=a["stage"].row3.long()),
    "row3-width": lambda a: _stage(a, row3=a["stage"].row3[:, :2]),
    "w1-width": lambda a: _stage(a, w1=a["stage"].w1[:, :3]),
    "w1-unaligned": lambda a: _stage(a, w1=torch.zeros(
        (a["stage"].w1.numel() + 1,), device="meta")[1:].view(-1, 4)),
    "pair_valid-rows": lambda a: _stage(a, pair_valid=a["stage"].pair_valid[:-1]),
    "double_sided-dtype": lambda a: _stage(a, double_sided=a["stage"].double_sided.int()),
    "scene_tri-cpu": lambda a: _stage(a, scene_tri=torch.zeros(a["stage"].scene_tri.shape,
                                                               dtype=torch.int32)),
    "view_proj-shape": lambda a: dict(a, view_proj=a["view_proj"][:3]),
    "view_proj-dtype": lambda a: dict(a, view_proj=a["view_proj"].double()),
    "view_proj-transposed": lambda a: dict(a, view_proj=a["view_proj"].t()),
    "width-0": lambda a: dict(a, width=0),
    "out-setup-width": lambda a: _setup_out(a, setup=torch.zeros(
        (a["stage"].row3.shape[0], 15), device="meta")),
    "out-bbox-unaligned": lambda a: _setup_out(a, bbox=torch.zeros(
        (a["stage"].row3.shape[0] * 4 + 1,), dtype=torch.int32, device="meta")[1:].view(-1, 4)),
    "out-valid-dtype": lambda a: _setup_out(a, valid=torch.zeros(
        (a["stage"].row3.shape[0],), dtype=torch.uint8, device="meta")),
    "out-tri_id-missing": lambda a: _setup_out(a, tri_id=None),
}


@pytest.mark.parametrize("fault", sorted(SETUP_FAULTS) + ["none", "none-out"])
def test_view_setup_wrapper_raises_off_the_cpu(fault):
    args = _meta(setup_args("crafted", False, "cpu"))
    if fault == "none-out":
        args = _setup_out(args)
    elif fault in SETUP_FAULTS:
        args = SETUP_FAULTS[fault](args)
    with pytest.raises((ValueError, TypeError),
                       match="CUDA tensors" if fault.startswith("none") else None):
        port_geom.geometry_view_setup(**args)


def _merged_setup_meta():
    stages = port_geom.geometry_vertex_stage_merged_plain(**merged_args("static+skinned", "cpu"))
    args = _meta(merged_setup_args(stages, False, 64, 32, "cpu"))
    rows = sum(s.row3.shape[0] for s in args["stages"])
    return dict(args, out=port_geom.setup_table(rows, "meta"))


def _stages(a, i, **kw):
    stages = list(a["stages"])
    stages[i] = stages[i]._replace(**kw)
    return dict(a, stages=tuple(stages))


MERGED_SETUP_FAULTS = {
    "stages-empty": lambda a: dict(a, stages=()),
    "stages-three": lambda a: dict(a, stages=a["stages"] + a["stages"][:1]),
    "num_valid-dtype": lambda a: _stages(a, 1, num_valid=a["stages"][1].num_valid.long()),
    "num_valid-missing": lambda a: _stages(a, 0, num_valid=None),
    "num_valid-shape": lambda a: _stages(a, 0, num_valid=a["stages"][0].num_valid[None]),
    "second-row3-dtype": lambda a: _stages(a, 1, row3=a["stages"][1].row3.long()),
    "second-w1-unaligned": lambda a: _stages(a, 1, w1=torch.zeros(
        (a["stages"][1].w1.numel() + 1,), device="meta")[1:].view(-1, 4)),
    "second-pair_inst-rows": lambda a: _stages(a, 1, pair_inst=a["stages"][1].pair_inst[:-1]),
    "second-on-another-device": lambda a: _stages(a, 1, w1=torch.zeros(
        a["stages"][1].w1.shape)),
    "out-rows": lambda a: dict(a, out=port_geom.setup_table(a["out"].setup.shape[0] + 1,
                                                            "meta")),
    "view_proj-dtype": lambda a: dict(a, view_proj=a["view_proj"].double()),
    "height-0": lambda a: dict(a, height=0),
}


@pytest.mark.parametrize("fault", sorted(MERGED_SETUP_FAULTS) + ["none", "none-no-out"])
def test_merged_view_setup_wrapper_raises_off_the_cpu(fault):
    args = _merged_setup_meta()
    if fault == "none-no-out":
        args["out"] = None
    elif fault in MERGED_SETUP_FAULTS:
        args = MERGED_SETUP_FAULTS[fault](args)
    with pytest.raises((ValueError, TypeError),
                       match="CUDA tensors" if fault.startswith("none") else None) as err:
        port_geom.geometry_view_setup_merged(**args)
    assert fault.startswith("none") or "runs on CUDA tensors" not in str(err.value)


# --- the ctypes mirrors ---------------------------------------------------------------

def _cu_fields(struct: str) -> list:
    """[(field, array length or 1)] of a struct of csrc/geometry.cu, in
    order, from the source."""
    path = os.path.join(os.path.dirname(port_geom.__file__), os.pardir, "csrc", "geometry.cu")
    with open(path) as f:
        src = f.read()
    body = re.search(r"struct " + struct + r" \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in body.split(";")[:-1]:
        m = re.search(r"(\w+)(?:\[(\w+)\])?\s*$", decl.strip())
        out.append((m.group(1), m.group(2) or 1))
    return out


@pytest.mark.parametrize("struct", ["VertexArgs", "ListArgs", "SetupArgs", "SetupPart"])
def test_mirrors_name_the_structs_fields(struct):
    """Each ctypes mirror of a struct of csrc/geometry.cu names its fields in
    order, each 8 B (a pointer or a long long) and its list of kMaxLists
    parts (MAX_LISTS); sc_geometry_args_bytes' order of the structs is the
    mirrors'. On the card the sizes themselves are compared
    (test_torch_geometry_card.py)."""
    mirror = getattr(port_geom, "_" + struct)
    cu = _cu_fields(struct)
    assert [f for f, _ in mirror._fields_] == [f for f, _ in cu]
    for (name, ctype), (_, length) in zip(mirror._fields_, cu):
        if length == 1:
            assert ctypes.sizeof(ctype) == 8, name
        else:
            assert length == "kMaxLists" and ctype._length_ == port_geom.MAX_LISTS, name
    assert port_geom._MIRRORS.index(mirror) == ["VertexArgs", "SetupArgs", "ListArgs",
                                                "SetupPart"].index(struct)


# --- chip_smoke.py's bound ------------------------------------------------------------

def _tiny_list(skinned: bool) -> dict:
    """One valid draw of 4 vertices (scene rows 2-5) and 2 triangles
    (scene triangles 1-2), and an invalid one; t_cap 3, v_cap 6: the
    padding slots read scene vertex 0 and scene triangle 0."""
    draws = port_geom.make_draw_list(
        np.tile(np.array([0, 0, 0, 1, 0, 0, 0, 1], np.float32), (2, 1)), [1, 0], [2, 5],
        first_vertex=[2, 0], vertex_count=[4, 9], material=[1, 0], valid=[True, False],
        device="cpu")
    f32 = torch.float32
    args = dict(
        draws=draws, indices=torch.tensor([0, 1, 2, 2, 3, 4, 3, 4, 5, 5, 4, 3], dtype=torch.int32),
        positions=torch.zeros((8, 3)), normals=torch.zeros((8, 3)), uvs=torch.zeros((8, 2)),
        lm_uvs=None if skinned else torch.zeros((8, 2)),
        tri_material=torch.tensor([0, 1, 1, 0], dtype=torch.int32),
        materials={"uv_offset": torch.zeros((3, 2)), "uv_scale": torch.ones((3, 2)),
                   "uv_rotation": torch.zeros(3), "flags": torch.zeros(3, dtype=torch.int32)},
        t_cap=3, v_cap=6, joint_palette=None, joint_indices=None, joint_weights=None, out=None)
    if skinned:
        args.update(joint_palette=torch.zeros((4, 8), dtype=f32),
                    joint_indices=torch.tensor([[0, 1, 1, 9]] * 8, dtype=torch.int32),
                    joint_weights=torch.ones((8, 4)))
    return args


@pytest.mark.parametrize("skinned", [False, True])
def test_vertex_stage_bound_counts_what_the_list_reads(skinned):
    """The bytes: 2 draws x 54 B (sim8, five int columns, two flags; 58 B
    with joints_offset); 5 distinct scene vertices (0 and 2-5) x 40 B (32
    B without lightmap uvs, 32 B more with joints); 3 distinct palette rows
    (0, 1 and 9 clamped to 3) x 32 B; one draw material (draw 0's, which
    the padding slots read too) x 20 B and the triangles' materials (0 and
    1) x 4 B; 3 distinct scene triangles (0 for the padding, 1 and 2) x 16
    B; written, 6 vertex slots x 16 B, 3 triangle slots x 151 B and the
    count (4 B)."""
    args = _tiny_list(skinned)
    nbytes, ops = chip_smoke.geometry_bytes_ops("geometry_vertex_stage", args)
    vertex = (32 + 32) if skinned else 40
    want = (2 * (58 if skinned else 54) + 5 * vertex + (3 * 32 if skinned else 0) + 20
            + 2 * 4 + 3 * 16 + 6 * 16 + 3 * 151 + 4)
    assert nbytes == want
    per_vertex = chip_smoke.GEOMETRY_OPS_VERTEX + (chip_smoke.GEOMETRY_OPS_SKIN if skinned else 0)
    assert ops == 6 * per_vertex
    bound_ms, by = chip_smoke.geometry_bound("geometry_vertex_stage", args, [])
    assert by == "bytes" and bound_ms == pytest.approx(want / 3.35e9)


@pytest.mark.parametrize("out", [False, True])
def test_view_setup_bound_counts_what_the_view_reads(out):
    """A stage of the tiny list: 3 triangle slots read row3, pair_valid and
    double_sided (14 B), the w1 rows of their 4 distinct corner slots (16 B
    each) and the matrix (64 B), and write 81 B (with `out` also tri_id and
    inst_id, read and written: 16 B more)."""
    stage = port_geom.geometry_vertex_stage(**_tiny_list(False))
    assert len(torch.unique(stage.row3)) == 4
    args = dict(stage=stage, view_proj=torch.eye(4), width=64, height=32, flip_viewport=False,
                out=port_geom.setup_table(3, "cpu") if out else None)
    nbytes, ops = chip_smoke.geometry_bytes_ops("geometry_view_setup", args)
    assert nbytes == 3 * (14 + 81 + (16 if out else 0)) + 4 * 16 + 64
    assert ops == 3 * chip_smoke.GEOMETRY_OPS_SETUP + 4 * chip_smoke.GEOMETRY_OPS_CLIP


@pytest.mark.parametrize("case", sorted(MERGED_CASES))
def test_merged_bound_is_the_sum_of_the_lists(case):
    """A merged vertex stage's and a merged setup's bound, bytes, lanes and
    rows are their lists' summed; the setup's parts count tri_id and
    inst_id, which the merged kernel always writes."""
    args = merged_args(case, "cpu")
    parts = [("geometry_vertex_stage", dict(lst._asdict(), materials=args["materials"], out=None))
             for lst in args["lists"]]
    name = "geometry_vertex_stage_merged"
    assert chip_smoke.geometry_bytes_ops(name, args) == tuple(
        sum(x) for x in zip(*[chip_smoke.geometry_bytes_ops(n, a) for n, a in parts]))
    bound, by = chip_smoke.geometry_bound(name, args, [])
    assert by == "bytes"
    assert bound == pytest.approx(sum(chip_smoke.geometry_bound(n, a, [])[0] for n, a in parts))
    assert chip_smoke.geometry_lanes(name, args) == sum(
        chip_smoke.geometry_lanes(n, a) for n, a in parts)
    assert chip_smoke.geometry_calls(name, args) == 2
    assert "static t_cap" in chip_smoke.geometry_site(name, "caller", args)

    stages = port_geom.geometry_vertex_stage_merged_plain(**args)
    sargs = merged_setup_args(stages, False, 64, 32, "cpu")
    sparts = [("geometry_view_setup", dict(stage=s, view_proj=sargs["view_proj"], width=64,
                                           height=32, flip_viewport=False,
                                           out=port_geom.setup_table(s.row3.shape[0], "cpu")))
              for s in stages]
    name = "geometry_view_setup_merged"
    for out in (sargs["out"], None):
        got = chip_smoke.geometry_bound(name, dict(sargs, out=out), [])[0]
        assert got == pytest.approx(sum(chip_smoke.geometry_bound(n, a, [])[0]
                                        for n, a in sparts))
    assert chip_smoke.geometry_calls(name, sargs) == 1
    assert len(chip_smoke.geometry_rows(name, sargs, [])) == 2

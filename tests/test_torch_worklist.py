"""The shading worklists' wrappers (ops/worklist.py worklist_compact,
worklist_compose and worklist_compose_clip, csrc/worklist.cu) on the CPU,
where they run their plain versions:

* the port's compaction (render/frame.py _compact_worklist) against the
  JAX package's _compact_worklist on the same seeded masks (all dead, all
  live, sparse, dense, rectangles), caps above and below the count, at
  granules of 1, 8 and 128 pixels from 64x8 to 256x128: idx, safe, live
  and need bit for bit; worklist_compact itself equal to it;
* the compose against both branches of the JAX package's
  _compose_worklist (the scatter, at cap * 8 < granules, and the rank
  gather otherwise), byte for byte, on i32, f32 and f32 x 3 destinations;
* the lane-mask form equal to composing where(ok, rows, take(dst)), the
  in-place form returning dst's storage and equal to the copying plain
  version;
* one alpha-clip round (_Worklist.compose with clip=, worklist_compose_clip
  and its plain version) against the JAX package's round
  (superconductor_tpu/render/frame.py:951-966, its take and compose) bit
  for bit: seeded masks at gr 1 and 128, caps under and over the need, a
  found plane of 0 and 1, alpha and cutoff with NaN and ties, dead slots;
* the compaction's grid by its rule (compact_blocks): GRID_BLOCKS blocks
  at the frames' shapes, one for each CHUNK granules past that (507 at gr
  = 1 and 1080p), never more than the granules;
* render/frame.py's bindings: WORKLIST_PLAIN_VERSIONS names the wrappers
  the frame calls, _compact_worklist / compose / take stay there, a frame
  with the plain versions bound is byte-equal to the frame, calls the
  clip-round form once a round, and rebinding a wrapper sends the frame
  eager;
* the wrappers raising, off the CPU, on what their kernels do not take
  (meta tensors stand in for a card's).

The kernels themselves run in tests/test_torch_worklist_card.py (-m gpu)."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_tpu.render import frame as ref_frame
from superconductor_tpu_torch.ops import worklist as wl_mod
from superconductor_tpu_torch.render import frame as port_frame
from superconductor_tpu_torch.render import frame_graph
from test_torch_worklist_card import (
    CAPS,
    GRANULES,
    KINDS,
    cap_px,
    compose_inputs,
    mask_case,
    same_bits,
)

torch.set_num_threads(2)

SIZES = {1: ((64, 8), (256, 128)), 8: ((64, 8), (256, 128)), 128: ((128, 8), (256, 128))}
CASES = [(kind, gr, size, cap) for gr in GRANULES for size in SIZES[gr] for kind in KINDS
         for cap in CAPS]


def _case_id(case):
    kind, gr, (w, h), cap = case
    return f"{kind}-gr{gr}-{w}x{h}-cap_{cap}"


def _worklists(kind, gr, size, cap):
    """(mask, pixel cap, port worklist, reference worklist) of a case."""
    w, h = size
    mask = mask_case(kind, w, h, seed=gr * 7 + w)
    px = cap_px(mask, gr, cap)
    port = port_frame._compact_worklist(
        torch.from_numpy(mask), px, port_frame.RenderConfig(width=w, height=h, granule_px=gr))
    ref = ref_frame._compact_worklist(
        jnp.asarray(mask), px, ref_frame.RenderConfig(width=w, height=h, granule_px=gr))
    return mask, px, port, ref


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_compaction_matches_reference(case):
    kind, gr, size, cap = case
    mask, px, port, ref = _worklists(*case)
    assert port.gr == ref.gr == gr and port.npx == ref.npx == mask.shape[0]
    for name in ("idx", "safe", "live", "need"):
        a, b = getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert a.tobytes() == b.tobytes(), name
    if cap == "below" and kind != "all_dead":
        # an overflow: every slot live, and granules past the cap dropped
        assert bool(port.live.all()) and int(port.need) > port.idx.shape[0] * gr
    cap_g = max(1, min(px, mask.shape[0]) // gr)
    direct = wl_mod.worklist_compact(torch.from_numpy(mask), gr, cap_g)
    for a, b in zip(direct, (port.idx, port.safe, port.live, port.need)):
        assert same_bits(a, b)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_compose_matches_both_reference_branches(case):
    kind, gr, size, cap = case
    mask, px, port, ref = _worklists(*case)
    slots = port.idx.shape[0]
    branch = "scatter" if slots * 8 < mask.shape[0] // gr else "gather"
    for name, dst, rows, where in compose_inputs(slots, gr, mask.shape[0], seed=slots):
        if where is not None:
            continue
        got = port.compose(dst.clone(), rows)
        want = np.asarray(ref.compose(jnp.asarray(dst.numpy()), jnp.asarray(rows.numpy())))
        assert got.numpy().tobytes() == want.tobytes(), (name, branch)


def test_cases_reach_both_reference_branches():
    branches = set()
    for case in CASES:
        _mask, _px, port, _ref = _worklists(*case)
        branches.add(port.idx.shape[0] * 8 < port.npx // port.gr)
    assert branches == {True, False}


@pytest.mark.parametrize("case", CASES[::3], ids=_case_id)
def test_compose_lane_mask_and_in_place(case):
    kind, gr, size, cap = case
    mask, _px, port, ref = _worklists(*case)
    for name, dst, rows, where in compose_inputs(port.idx.shape[0], gr, mask.shape[0], seed=3):
        if where is None:
            continue
        wide = where if rows.ndim == 1 else where[:, None]
        # the lane-mask form against the form the clip rounds composed before
        got = port.compose(dst.clone(), rows, where=where)
        want = port.compose(dst.clone(), torch.where(wide, rows, port.take(dst)))
        assert same_bits(got, want), name
        ref_rows = jnp.where(jnp.asarray(wide.numpy()), jnp.asarray(rows.numpy()),
                             ref.take(jnp.asarray(dst.numpy())))
        ref_out = np.asarray(ref.compose(jnp.asarray(dst.numpy()), ref_rows))
        assert got.numpy().tobytes() == ref_out.tobytes(), name
        # in place: the wrapper returns dst's storage, equal to the copying plain form
        for w in (None, where):
            d = dst.clone()
            out = wl_mod.worklist_compose(d, port.idx, rows, gr, w)
            plain = wl_mod.worklist_compose_plain(dst, port.idx, rows, gr, w)
            assert out.data_ptr() == d.data_ptr() and out.shape == dst.shape
            assert plain.data_ptr() != dst.data_ptr()
            assert same_bits(out, plain), name


CLIP_CASES = [(kind, gr, cap, found) for gr in (1, 128) for kind in ("sparse", "rects", "all_dead")
              for cap in CAPS for found in ("zeros", "mixed")]


def _clip_inputs(kind, gr, cap, found, seed):
    """A clip round's seeded inputs at 256x128: the layer's pair plane (-1
    where the mask is clear), its depth plane, the found / chosen planes
    carried in (found 0, or 0 and 1), and for the round's lanes (made once
    the lane count is known: `lanes(n)`) valid, alpha and cutoff with NaN
    and ties."""
    w, h = 256, 128
    rng = np.random.default_rng(seed)
    mask = mask_case(kind, w, h, seed=seed)
    npx = w * h
    layer_pair = np.where(mask, rng.integers(0, 5000, npx), -1).astype(np.int32)
    layer_depth = rng.standard_normal(npx).astype(np.float32)
    found_p = (np.zeros(npx, np.int32) if found == "zeros"
               else (rng.random(npx) < 0.4).astype(np.int32))
    chosen_pair = rng.integers(-1, 5000, npx).astype(np.int32)
    chosen_depth = rng.standard_normal(npx).astype(np.float32)

    def lanes(n):
        valid = rng.random(n) < 0.7
        alpha = rng.random(n).astype(np.float32)
        cutoff = rng.random(n).astype(np.float32)
        tie = rng.random(n) < 0.2
        cutoff[tie] = alpha[tie]
        alpha[rng.random(n) < 0.05] = np.nan
        cutoff[rng.random(n) < 0.05] = np.nan
        return valid, alpha, cutoff

    return (w, h, mask, cap_px(mask, gr, cap), layer_pair, layer_depth, found_p, chosen_pair,
            chosen_depth, lanes)


def _clip_id(case):
    kind, gr, cap, found = case
    return f"{kind}-gr{gr}-cap_{cap}-found_{found}"


@pytest.mark.parametrize("case", CLIP_CASES, ids=_clip_id)
def test_clip_round_matches_reference(case):
    """_Worklist.compose's clip-round form (the wrapper's CPU route, the
    plain version) against the JAX package's round, bit for bit: found,
    chosen pair and chosen depth; the planes written in place."""
    kind, gr, cap, found = case
    (w, h, mask, px, layer_pair, layer_depth, found_p, chosen_pair, chosen_depth,
     lanes) = _clip_inputs(kind, gr, cap, found, seed=GRANULES.index(gr) * 10 + len(kind))
    port = port_frame._compact_worklist(
        torch.from_numpy(mask), px, port_frame.RenderConfig(width=w, height=h, granule_px=gr))
    ref = ref_frame._compact_worklist(
        jnp.asarray(mask), px, ref_frame.RenderConfig(width=w, height=h, granule_px=gr))
    assert port.gr == ref.gr == gr
    n = port.idx.shape[0] * gr
    valid, alpha, cutoff = lanes(n)
    raw = np.asarray(ref.take(jnp.asarray(layer_pair)))
    pair_k = np.where(np.asarray(ref.lane_live()) & (raw >= 0), raw, -1).astype(np.int32)

    # the reference's round (superconductor_tpu/render/frame.py:951-966)
    r_found = jnp.asarray(found_p)
    r_pair, r_depth = jnp.asarray(chosen_pair), jnp.asarray(chosen_depth)
    cur_found = ref.take(r_found) != 0
    ok = jnp.asarray(valid) & (jnp.asarray(alpha) >= jnp.asarray(cutoff)) & ~cur_found
    want = (ref.compose(r_found, (cur_found | ok).astype(jnp.int32)),
            ref.compose(r_pair, jnp.where(ok, jnp.asarray(pair_k), ref.take(r_pair))),
            ref.compose(r_depth, jnp.where(ok, ref.take(jnp.asarray(layer_depth)),
                                           ref.take(r_depth))))
    # alpha and cutoff as albedo_alpha returns them: columns of wider rows
    alpha_t = torch.from_numpy(np.repeat(alpha[:, None], 4, axis=1))[:, 3]
    cutoff_t = torch.from_numpy(np.repeat(cutoff[:, None], 11, axis=1))[:, 10]
    args = dict(rows=torch.from_numpy(pair_k),
                clip=(torch.from_numpy(valid), alpha_t, cutoff_t,
                      torch.from_numpy(layer_depth)))
    planes = tuple(torch.from_numpy(x.copy()) for x in (found_p, chosen_pair, chosen_depth))
    got = port.compose(planes, **args)
    assert all(g.data_ptr() == p.data_ptr() for g, p in zip(got, planes))
    for g, r in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(r).tobytes()
    plain = wl_mod.worklist_compose_clip_plain(
        *(torch.from_numpy(x) for x in (found_p, chosen_pair, chosen_depth)), port.idx,
        args["rows"], gr, *args["clip"])
    for g, p in zip(got, plain):
        assert same_bits(g, p)
    if kind != "all_dead":
        found_ok = np.asarray(want[0]) != found_p
        assert found_ok.any()  # some lane found its fragment this round
    if cap == "below" and kind != "all_dead":
        assert int(port.need) > n  # dead granules past the cap kept their planes


def test_clip_cases_reach_dead_slots_nan_and_ties():
    """The clip cases hold slots past the count (sentinels) and lanes whose
    alpha test is a NaN or a tie."""
    kinds = set()
    for kind, gr, cap, found in CLIP_CASES:
        (w, h, mask, px, *_rest, lanes) = _clip_inputs(kind, gr, cap, found, seed=1)
        wl = port_frame._compact_worklist(
            torch.from_numpy(mask), px, port_frame.RenderConfig(width=w, height=h, granule_px=gr))
        valid, alpha, cutoff = lanes(wl.idx.shape[0] * gr)
        if not bool(wl.live.all()):
            kinds.add("dead")
        if np.isnan(alpha).any() and np.isnan(cutoff).any():
            kinds.add("nan")
        if (alpha == cutoff).any():
            kinds.add("tie")
    assert kinds == {"dead", "nan", "tie"}


@pytest.mark.parametrize("npx, gr, blocks", [
    (1920 * 1080, 128, 128),  # every 1080p frame's worklists
    (1920 * 270, 128, 128),  # a sharded frame's 270-row band
    (1920 * 1080, 8, 128),
    (64 * 8, 128, 4),  # fewer granules than blocks
    (1920 * 1080, 3, 169),
    (3840 * 2160, 2, 1013),
    (1920 * 1080, 1, 507),  # the headline at gr = 1
    (7680 * 4320, 1, 8100),  # more than the card holds: held there, runs in chunks
    (4096 * 128, 1, 128),  # exactly CHUNK granules a block
])
def test_compaction_blocks_by_rule(npx, gr, blocks):
    """The compaction's grid: GRID_BLOCKS blocks where each then owns at
    most CHUNK granules, else one block for each CHUNK granules; never
    more blocks than granules."""
    n_g = npx // gr
    assert wl_mod.compact_blocks(n_g) == blocks
    assert blocks <= n_g and (blocks == wl_mod.GRID_BLOCKS or blocks == n_g
                              or -(-n_g // (blocks - 1)) > wl_mod.CHUNK)
    assert -(-n_g // blocks) <= wl_mod.CHUNK


def test_frames_compact_with_grid_blocks_at_1080p():
    """The frames' worklists at 1080p use 128-pixel granules, and a band of
    any frame compacts in a grid of GRID_BLOCKS blocks, each run one chunk."""
    config = port_frame.RenderConfig(width=1920, height=1080)
    for rows in (1080, 270):
        npx = 1920 * rows
        gr = port_frame._worklist_granule(config, npx)
        assert gr == 128 and wl_mod.compact_blocks(npx // gr) == wl_mod.GRID_BLOCKS
        assert -(-(npx // gr) // wl_mod.GRID_BLOCKS) <= wl_mod.CHUNK


def test_frame_binds_the_wrappers():
    """WORKLIST_PLAIN_VERSIONS names the wrappers render/frame.py calls
    (module globals): the compose kernel's two, the rows' form and the
    clip round's; the clip rounds run in a function of their own; the
    worklist functions the benchmark's sites name stay in
    render/frame.py."""
    table = port_frame.WORKLIST_PLAIN_VERSIONS
    assert set(table) == {"worklist_compact", "worklist_compose"}
    names = {}
    for kernel, bindings in table.items():
        for mod, name, plain in bindings:
            assert mod is port_frame and name.startswith(kernel)
            assert getattr(port_frame, name) is getattr(wl_mod, name)
            assert plain is getattr(wl_mod, name + "_plain")
            names[name] = kernel
    assert names == {"worklist_compact": "worklist_compact",
                     "worklist_compose": "worklist_compose",
                     "worklist_compose_clip": "worklist_compose"}
    assert port_frame._clip_rounds.__module__ == port_frame.__name__
    assert port_frame._compact_worklist.__module__ == port_frame.__name__
    for method in ("compose", "take"):
        fn = getattr(port_frame._Worklist, method)
        assert fn.__module__ == port_frame.__name__ and fn.__name__ == method


def test_frame_calls_the_wrappers_and_plain_twin_is_equal(monkeypatch):
    """A small all-passes frame calls worklist_compact from every
    _compact_worklist, worklist_compose_clip once a clip round (from
    compose, in _clip_rounds) and worklist_compose from every other
    compose (the sky's without a lane mask, the opaque shade's with one);
    bound to the plain versions it is byte for byte the same frame, and a
    rebound wrapper sends it eager."""
    from superconductor_tpu_torch.render.caps import fit_caps
    from superconductor_tpu_torch.scenes import all_passes_scene

    tables, build, config, env = all_passes_scene(128, 64, "cpu", stacks=8,
                                                  lod_screen_height=32)
    state = build(0.0)
    config = fit_caps(tables, state, config, env)
    img = port_frame.render_frame(tables, state, config, env)
    calls = {"compact": 0, "compose": [], "worklists": 0, "clip": []}
    real_wl = port_frame._compact_worklist

    def compact(mask, gr, cap_g):
        calls["compact"] += 1
        return wl_mod.worklist_compact_plain(mask, gr, cap_g)

    def compose(dst, idx, rows, gr, where=None):
        calls["compose"].append(where is not None)
        return wl_mod.worklist_compose_plain(dst, idx, rows, gr, where)

    def compose_clip(found, pair, depth, idx, rows, gr, valid, alpha, cutoff, layer_depth):
        calls["clip"].append(sys._getframe(2).f_code.co_name)
        return wl_mod.worklist_compose_clip_plain(found, pair, depth, idx, rows, gr, valid,
                                                  alpha, cutoff, layer_depth)

    def worklists(*args):
        calls["worklists"] += 1
        return real_wl(*args)

    monkeypatch.setattr(port_frame, "worklist_compact", compact)
    monkeypatch.setattr(port_frame, "worklist_compose", compose)
    monkeypatch.setattr(port_frame, "worklist_compose_clip", compose_clip)
    monkeypatch.setattr(port_frame, "_compact_worklist", worklists)
    assert not frame_graph.frame_bindings_intact()
    twin = port_frame.render_frame(tables, state, config, env)
    assert torch.equal(img, twin)
    assert calls["compact"] == calls["worklists"] > 0
    clip_rounds = config.resolve_clip_layers() if config.enable_clip else 0
    assert clip_rounds > 0 and calls["clip"] == ["_clip_rounds"] * clip_rounds
    assert calls["compose"] and not all(calls["compose"])


def _compose_args(**kw):
    args = dict(dst=torch.zeros((64, 3), device="meta"),
                idx=torch.zeros((4,), dtype=torch.int32, device="meta"),
                rows=torch.zeros((32, 3), device="meta"), gr=8, where=None)
    args.update(kw)
    return args


COMPOSE_FAULTS = {
    "dst-dtype": _compose_args(dst=torch.zeros((64, 3), dtype=torch.float16, device="meta"),
                               rows=torch.zeros((32, 3), dtype=torch.float16, device="meta")),
    "dst-3d": _compose_args(dst=torch.zeros((64, 3, 1), device="meta")),
    "dst-strided": _compose_args(dst=torch.zeros((3, 64), device="meta").t()),
    "dst-ragged": _compose_args(dst=torch.zeros((60, 3), device="meta")),
    "gr-0": _compose_args(gr=0),
    "idx-int64": _compose_args(idx=torch.zeros((4,), dtype=torch.int64, device="meta")),
    "idx-2d": _compose_args(idx=torch.zeros((4, 1), dtype=torch.int32, device="meta")),
    "rows-dtype": _compose_args(rows=torch.zeros((32, 3), dtype=torch.int32, device="meta")),
    "rows-shape": _compose_args(rows=torch.zeros((31, 3), device="meta")),
    "rows-strided": _compose_args(rows=torch.zeros((3, 32), device="meta").t()),
    "where-dtype": _compose_args(where=torch.zeros((32,), dtype=torch.uint8, device="meta")),
    "where-shape": _compose_args(where=torch.zeros((33,), dtype=torch.bool, device="meta")),
    "meta-device": _compose_args(),
}


@pytest.mark.parametrize("fault", sorted(COMPOSE_FAULTS))
def test_compose_raises_on_what_its_kernel_does_not_take(fault):
    with pytest.raises(ValueError):
        wl_mod.worklist_compose(**COMPOSE_FAULTS[fault])


def _clip_args(**kw):
    args = dict(found=torch.zeros((64,), dtype=torch.int32, device="meta"),
                pair=torch.zeros((64,), dtype=torch.int32, device="meta"),
                depth=torch.zeros((64,), device="meta"),
                idx=torch.zeros((4,), dtype=torch.int32, device="meta"),
                rows=torch.zeros((32,), dtype=torch.int32, device="meta"), gr=8,
                valid=torch.zeros((32,), dtype=torch.bool, device="meta"),
                alpha=torch.zeros((32, 4), device="meta")[:, 3],
                cutoff=torch.zeros((32,), device="meta"),
                layer_depth=torch.zeros((64,), device="meta"))
    args.update(kw)
    return args


COMPOSE_CLIP_FAULTS = {
    "found-dtype": _clip_args(found=torch.zeros((64,), device="meta")),
    "found-2d": _clip_args(found=torch.zeros((64, 1), dtype=torch.int32, device="meta")),
    "found-ragged": _clip_args(found=torch.zeros((60,), dtype=torch.int32, device="meta")),
    "pair-dtype": _clip_args(pair=torch.zeros((64,), dtype=torch.int64, device="meta")),
    "pair-strided": _clip_args(
        pair=torch.zeros((128,), dtype=torch.int32, device="meta")[::2]),
    "depth-dtype": _clip_args(depth=torch.zeros((64,), dtype=torch.float64, device="meta")),
    "depth-shape": _clip_args(depth=torch.zeros((63,), device="meta")),
    "layer-depth-strided": _clip_args(layer_depth=torch.zeros((128,), device="meta")[::2]),
    "gr-0": _clip_args(gr=0),
    "idx-int64": _clip_args(idx=torch.zeros((4,), dtype=torch.int64, device="meta")),
    "rows-dtype": _clip_args(rows=torch.zeros((32,), device="meta")),
    "rows-strided": _clip_args(rows=torch.zeros((64,), dtype=torch.int32, device="meta")[::2]),
    "valid-dtype": _clip_args(valid=torch.zeros((32,), dtype=torch.uint8, device="meta")),
    "alpha-shape": _clip_args(alpha=torch.zeros((31,), device="meta")),
    "cutoff-2d": _clip_args(cutoff=torch.zeros((32, 1), device="meta")),
    "meta-device": _clip_args(),
}


@pytest.mark.parametrize("fault", sorted(COMPOSE_CLIP_FAULTS))
def test_compose_clip_raises_on_what_its_kernel_does_not_take(fault):
    with pytest.raises(ValueError):
        wl_mod.worklist_compose_clip(**COMPOSE_CLIP_FAULTS[fault])


COMPACT_FAULTS = {
    "mask-dtype": (torch.zeros((64,), dtype=torch.uint8, device="meta"), 8, 4),
    "mask-2d": (torch.zeros((8, 8), dtype=torch.bool, device="meta"), 8, 4),
    "mask-strided": (torch.zeros((128,), dtype=torch.bool, device="meta")[::2], 8, 4),
    "mask-empty": (torch.zeros((0,), dtype=torch.bool, device="meta"), 8, 4),
    "gr-ragged": (torch.zeros((60,), dtype=torch.bool, device="meta"), 8, 4),
    "gr-0": (torch.zeros((64,), dtype=torch.bool, device="meta"), 0, 4),
    "meta-device": (torch.zeros((64,), dtype=torch.bool, device="meta"), 8, 4),
    "blocks-0": (torch.zeros((64,), dtype=torch.bool, device="meta"), 8, 4, 0),
}


@pytest.mark.parametrize("fault", sorted(COMPACT_FAULTS))
def test_compact_raises_on_what_its_kernel_does_not_take(fault):
    with pytest.raises(ValueError):
        wl_mod.worklist_compact(*COMPACT_FAULTS[fault])

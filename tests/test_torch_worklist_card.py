"""The shading worklists' CUDA kernels against their plain versions on the
card, bit for bit: ops/worklist.py worklist_compact (csrc/worklist.cu
worklist_compact_kernel: one launch of a cooperative grid of
compact_blocks blocks), worklist_compose
(worklist_compose_kernel, in place) and worklist_compose_clip (the same
kernel's clip-round form, three planes in place). This file imports no
JAX: its tests run only where there is a card (-m gpu) and skip
elsewhere.

    python -m pytest -q -m gpu tests/test_torch_worklist_card.py

The cases also serve tests/test_torch_worklist.py, which holds the plain
versions to the JAX package on the CPU at small sizes; here they run at
1920x1080:

* masks (mask_case): all dead, all live, sparse and dense random pixels,
  a few filled rectangles (granules wholly set beside empty ones), at
  granules of 1, 8 and 128 pixels (and on the card 3, 24 and 96, which
  take the kernel's byte-wise and 16-B paths otherwise), each with a cap
  above the set granules' count and one below it (overflow);
* the compose at every such worklist: an i32 plane, an f32 plane and an
  f32 x 3 image, with and without a lane mask, and on the card rows and
  dst whose base is not 16-B aligned (the word-wise path);
* the clip round at 1920x1080, gr 128 and 1: seeded masks and caps as
  above, found planes of 0 and 1, alpha and cutoff with NaN and ties read
  as columns of wider rows;
* on the card only: a mask whose base is not 16-B aligned, the frames'
  slot counts (4 to 13,312) at grids of 1 to 1,024 blocks (a run of more
  than one chunk; more blocks than the card holds at once, which the entry
  point holds to what it does), an 8K mask at gr = 1 (33,177,600
  granules: the grid held to the card, each run in chunks), the
  all-passes frame at 1080p with every worklist cap halved (every call of
  its eager frame against its plain version), the kernels captured in a
  CUDA graph and replayed on changed inputs (gr = 128 and gr = 1), and
  the launch counters (one a compaction, one a clip round).
"""

import numpy as np
import pytest
import torch

from superconductor_tpu_torch.ops import worklist as wl_mod
from superconductor_tpu_torch.ops.worklist import (
    worklist_compact,
    worklist_compact_plain,
    worklist_compose,
    worklist_compose_clip,
    worklist_compose_clip_plain,
    worklist_compose_plain,
)

KINDS = ("all_dead", "all_live", "sparse", "dense", "rects")
GRANULES = (1, 8, 128)
CAPS = ("above", "below")  # the cap above the set pixels' count, or below it


def mask_case(kind: str, width: int, height: int, seed: int) -> np.ndarray:
    """A flat (height * width,) bool mask of the kind, from the seed."""
    rng = np.random.default_rng(seed)
    if kind == "all_dead":
        return np.zeros(height * width, bool)
    if kind == "all_live":
        return np.ones(height * width, bool)
    if kind in ("sparse", "dense"):
        return rng.random(height * width) < (0.02 if kind == "sparse" else 0.5)
    m = np.zeros((height, width), bool)
    for _ in range(6):
        y0, x0 = rng.integers(0, height), rng.integers(0, width)
        m[y0:y0 + rng.integers(1, height // 3 + 2), x0:x0 + rng.integers(1, width // 3 + 2)] = True
    return m.reshape(-1)


def cap_px(mask: np.ndarray, gr: int, cap: str) -> int:
    """A pixel cap the frame might pass (render/frame.py _compact_worklist):
    above the mask's granule-dilated count, or about half of it."""
    need = int(mask.reshape(-1, gr).any(axis=1).sum()) * gr
    if cap == "above":
        return min(need + need // 8 + 3 * gr, mask.shape[0])
    return max(gr, need // 2)


def compose_inputs(slots: int, gr: int, npx: int, seed: int) -> list:
    """[(name, dst, rows, where)] of seeded compose inputs: an i32 plane, an
    f32 plane and an f32 x 3 image, each without and with a lane mask."""
    rng = np.random.default_rng(seed)
    lanes = slots * gr
    out = []
    for name, shape, dtype in (("i32", (), np.int32), ("f32", (), np.float32),
                               ("f32x3", (3,), np.float32)):
        dst = (rng.standard_normal((npx,) + shape) * 100).astype(dtype)
        rows = (rng.standard_normal((lanes,) + shape) * 100).astype(dtype)
        where = rng.random(lanes) < 0.6
        out.append((name, torch.from_numpy(dst), torch.from_numpy(rows), None))
        out.append((name + " where", torch.from_numpy(dst), torch.from_numpy(rows),
                    torch.from_numpy(where)))
    return out


def clip_lanes(n: int, seed: int) -> tuple:
    """(valid, alpha, cutoff) of a clip round's n lanes from the seed:
    alpha and cutoff with ties (a fifth) and NaN (a twentieth each), each
    the column of wider rows that ops/shade.py albedo_alpha returns
    (strides 4 and 11)."""
    rng = np.random.default_rng(seed)
    valid = rng.random(n) < 0.7
    alpha = rng.random(n).astype(np.float32)
    cutoff = rng.random(n).astype(np.float32)
    tie = rng.random(n) < 0.2
    cutoff[tie] = alpha[tie]
    alpha[rng.random(n) < 0.05] = np.nan
    cutoff[rng.random(n) < 0.05] = np.nan
    return (torch.from_numpy(valid), torch.from_numpy(np.repeat(alpha[:, None], 4, 1))[:, 3],
            torch.from_numpy(np.repeat(cutoff[:, None], 11, 1))[:, 10])


def clip_planes(npx: int, found: str, seed: int) -> tuple:
    """(found, chosen pair, chosen depth, layer depth) planes (npx,) from the
    seed: found all 0 ("zeros") or 0 and 1 ("mixed")."""
    rng = np.random.default_rng(seed)
    found_p = (np.zeros(npx, np.int32) if found == "zeros"
               else (rng.random(npx) < 0.4).astype(np.int32))
    return tuple(torch.from_numpy(x) for x in (
        found_p, rng.integers(-1, 5000, npx).astype(np.int32),
        rng.standard_normal(npx).astype(np.float32),
        rng.standard_normal(npx).astype(np.float32)))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shape, dtype and bytes (f32 by their int32 views)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return torch.equal(a, b)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (csrc/worklist.cu has no CPU mode)")
    return torch.device("cuda")


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """A copy of t whose base is 4 B past a 16-B boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("gr", GRANULES + (3, 24, 96))
@pytest.mark.parametrize("kind", KINDS)
def test_compact_and_compose_match_plain_at_1080p(kind, gr, cap):
    dev = _card()
    width, height = 1920, 1080
    mask_np = mask_case(kind, width, height, seed=GRANULES.index(gr) if gr in GRANULES else gr)
    mask = torch.from_numpy(mask_np).to(dev)
    cap_g = max(1, cap_px(mask_np, gr, cap) // gr)
    got = worklist_compact(mask, gr, cap_g)
    want = worklist_compact_plain(mask, gr, cap_g)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert same_bits(a, b)
    idx = got[0]
    for name, dst, rows, where in compose_inputs(idx.shape[0], gr, width * height, seed=gr):
        dst, rows = dst.to(dev), rows.to(dev)
        where = None if where is None else where.to(dev)
        plain = worklist_compose_plain(dst, idx, rows, gr, where)
        for form in ("aligned", "unaligned"):
            d = dst.clone() if form == "aligned" else _unaligned(dst)
            r = rows if form == "aligned" else _unaligned(rows)
            out = worklist_compose(d, idx, r, gr, where)
            torch.cuda.synchronize()
            assert out.data_ptr() == d.data_ptr(), (name, form)
            assert same_bits(out, plain), (name, form)


@pytest.mark.gpu
@pytest.mark.parametrize("gr", (1, 8, 128))
def test_compact_unaligned_mask(gr):
    dev = _card()
    mask_np = mask_case("rects", 1920, 1080, seed=5)
    mask = _unaligned(torch.from_numpy(mask_np).to(dev))
    for cap in CAPS:
        cap_g = max(1, cap_px(mask_np, gr, cap) // gr)
        got = worklist_compact(mask, gr, cap_g)
        want = worklist_compact_plain(mask, gr, cap_g)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert same_bits(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("found", ("zeros", "mixed"))
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("gr", (1, 128))
@pytest.mark.parametrize("kind", ("sparse", "rects", "all_dead", "all_live"))
def test_compose_clip_matches_plain_at_1080p(kind, gr, cap, found):
    """One clip round's kernel against worklist_compose_clip_plain on the
    same inputs, every plane bit for bit, written in place; one launch."""
    dev = _card()
    width, height = 1920, 1080
    npx = width * height
    mask_np = mask_case(kind, width, height, seed=gr + len(kind))
    mask = torch.from_numpy(mask_np).to(dev)
    idx = worklist_compact(mask, gr, max(1, cap_px(mask_np, gr, cap) // gr))[0]
    lanes = idx.shape[0] * gr
    valid, alpha, cutoff = (t.to(dev) for t in clip_lanes(lanes, seed=gr))
    rng = np.random.default_rng(gr)
    rows = torch.from_numpy(rng.integers(-1, 9000, lanes).astype(np.int32)).to(dev)
    found_p, pair, depth, layer_depth = (t.to(dev) for t in clip_planes(npx, found, seed=gr))
    want = worklist_compose_clip_plain(found_p, pair, depth, idx, rows, gr, valid, alpha, cutoff,
                                       layer_depth)
    planes = (found_p.clone(), pair.clone(), depth.clone())
    n0 = worklist_compose_clip.LAUNCHES
    got = worklist_compose_clip(*planes, idx, rows, gr, valid, alpha, cutoff, layer_depth)
    torch.cuda.synchronize()
    assert worklist_compose_clip.LAUNCHES == n0 + 1
    for g, p, w in zip(got, planes, want):
        assert g.data_ptr() == p.data_ptr() and same_bits(g, w)
    if kind != "all_dead":
        assert not torch.equal(got[0], found_p)  # some lane found its fragment


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", (None, 1, 64, 1024))
def test_compact_at_the_frames_slot_counts(blocks):
    """The compaction at the frames' shape (16,200 granules of 128 px) and
    slot counts, bit for bit, one launch each: in the rule's grid
    (GRID_BLOCKS), in one block (its run two chunks), in 64 and in 1,024
    blocks (more than the card holds at once: held to what it does, where
    a grid barrier over blocks that never run would hang)."""
    dev = _card()
    for kind, seed in (("rects", 3), ("sparse", 4), ("all_live", 0)):
        mask = torch.from_numpy(mask_case(kind, 1920, 1080, seed=seed)).to(dev)
        for cap_g in (4, 384, 2304, 4608, 5376, 10240, 13312, 16200):
            n0 = worklist_compact.LAUNCHES
            got = worklist_compact(mask, 128, cap_g, blocks)
            want = worklist_compact_plain(mask, 128, cap_g)
            torch.cuda.synchronize()
            assert worklist_compact.LAUNCHES == n0 + 1
            for a, b in zip(got, want):
                assert same_bits(a, b), (kind, cap_g)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("sparse", "rects"))
def test_compact_past_what_the_card_holds(kind):
    """An 8K mask at gr = 1: 33,177,600 granules, a rule's grid of 8,100
    blocks that the entry point holds to what the card runs at once, each
    block flagging its run in chunks; bit for bit, caps under and over the
    need."""
    dev = _card()
    mask_np = mask_case(kind, 7680, 4320, seed=9)
    mask = torch.from_numpy(mask_np).to(dev)
    assert wl_mod.compact_blocks(mask.shape[0]) == 8100
    for cap in CAPS:
        cap_g = cap_px(mask_np, 1, cap)
        got = worklist_compact(mask, 1, cap_g)
        want = worklist_compact_plain(mask, 1, cap_g)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert same_bits(a, b), cap


@pytest.mark.gpu
@pytest.mark.parametrize("gr", (128, 96, 24, 8, 3, 1))
def test_one_launch_a_compaction(gr):
    """worklist_compact launches its kernel once at every granule size,
    gr = 1 at 1080p (2,073,600 granules, 507 blocks) too."""
    dev = _card()
    mask = torch.from_numpy(mask_case("dense", 1920, 1080, seed=gr)).to(dev)
    n0 = worklist_compact.LAUNCHES
    worklist_compact(mask, gr, 1000)
    assert worklist_compact.LAUNCHES == n0 + 1


class _Recorded:
    """Inside the block, every call of render/frame.py's worklist wrappers
    is kept with copies of what it writes in place (the compose's dst, the
    clip round's planes), and runs."""

    def __init__(self, monkeypatch):
        from superconductor_tpu_torch.render import frame as frame_mod

        self.calls = []
        for name in ("worklist_compact", "worklist_compose", "worklist_compose_clip"):
            real = getattr(wl_mod, name)

            def recorded(*args, _name=name, _real=real, **kw):
                import inspect

                bound = inspect.signature(_real).bind(*args, **kw)
                kept = {k: v.clone() if k in ("dst", "found", "pair", "depth") else v
                        for k, v in bound.arguments.items()}
                self.calls.append((_name, kept))
                return _real(*args, **kw)

            monkeypatch.setattr(frame_mod, name, recorded)


def _check_recorded(calls) -> dict:
    """Each recorded call's kernel against its plain version, bit for bit;
    -> calls by wrapper name."""
    counts = {}
    for name, args in calls:
        counts[name] = counts.get(name, 0) + 1
        fresh = {k: v.clone() if k in ("dst", "found", "pair", "depth") else v
                 for k, v in args.items()}
        got = getattr(wl_mod, name)(**fresh)
        want = getattr(wl_mod, name + "_plain")(**args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert same_bits(a, b), name
    return counts


@pytest.mark.gpu
def test_all_passes_frame_with_caps_halved(monkeypatch):
    """The all-passes frame at 1080p with every worklist cap halved: its
    compactions overflow (need above the cap), and every worklist call of
    its eager frame equals its plain version; the clip rounds call the
    clip-round form once each."""
    from dataclasses import replace

    from superconductor_tpu_torch.render.caps import fit_caps
    from superconductor_tpu_torch.render.frame import render_frame_impl
    from superconductor_tpu_torch.scenes import all_passes_scene

    _card()
    tables, build, config, env = all_passes_scene(1920, 1080, "cuda")
    state = build(0.0)
    config = fit_caps(tables, state, config, env)
    npx = 1920 * 1080

    def halved(caps):
        return None if caps is None else tuple(max(1, int(c) // 2) for c in caps)

    config = replace(config, opaque_px_cap=max(1, (config.opaque_px_cap or npx) // 2),
                     sky_px_cap=max(1, (config.sky_px_cap or npx) // 2),
                     shade_px_cap=max(1, config.shade_px_cap // 2),
                     shade_px_caps=halved(config.shade_px_caps),
                     clip_px_caps=halved(config.clip_px_caps))
    rec = _Recorded(monkeypatch)
    render_frame_impl(tables, state, config, env)
    over = [a for name, a in rec.calls if name == "worklist_compact"
            and int(a["mask"].reshape(-1, a["gr"]).any(dim=1).sum()) > a["cap_g"]]
    assert over
    counts = _check_recorded(rec.calls)
    assert counts["worklist_compose_clip"] == config.resolve_clip_layers()


@pytest.mark.gpu
def test_kernels_replay_in_a_cuda_graph():
    """The compaction, a compose and a clip round captured in one CUDA
    graph, replayed on new masks, rows and lanes copied into the graph's
    inputs: each replay equals the plain versions on those inputs (no state
    leaks from one replay into the next); the counters count launches, not
    captures."""
    dev = _card()
    gr, width, height = 128, 1920, 1080
    npx = width * height
    masks = [torch.from_numpy(mask_case(k, width, height, seed=s)).to(dev)
             for k, s in (("rects", 1), ("sparse", 2), ("all_dead", 0), ("all_live", 0),
                          ("rects", 7))]
    cap_g = 9000  # below the all-live count (16,200 granules), above the others'
    lanes = cap_g * gr
    mask = masks[0].clone()
    rows = torch.randn((lanes, 3), device=dev)
    base = torch.randn((npx, 3), device=dev)
    dst = base.clone()
    pair_rows = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    valid, alpha, cutoff = (t.to(dev) for t in clip_lanes(lanes, seed=0))
    planes0 = tuple(t.to(dev) for t in clip_planes(npx, "mixed", seed=0))
    planes = tuple(t.clone() for t in planes0[:3])
    layer_depth = planes0[3].clone()
    idx = worklist_compact(mask, gr, cap_g)[0]  # warm: the build
    worklist_compose(dst, idx, rows, gr)
    worklist_compose_clip(*planes, idx, pair_rows, gr, valid, alpha, cutoff, layer_depth)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    counters = (worklist_compact, worklist_compose, worklist_compose_clip)
    before = [c.LAUNCHES for c in counters]
    with torch.cuda.graph(graph):
        dst.copy_(base)
        for t, t0 in zip(planes, planes0):
            t.copy_(t0)
        result = worklist_compact(mask, gr, cap_g)
        worklist_compose(dst, result[0], rows, gr)
        worklist_compose_clip(*planes, result[0], pair_rows, gr, valid, alpha, cutoff,
                              layer_depth)
    assert [c.LAUNCHES for c in counters] == before
    gen = torch.Generator(device=dev).manual_seed(5)
    for i, m in enumerate(masks):
        mask.copy_(m)
        rows.normal_(generator=gen)
        pair_rows.random_(-1, 9000, generator=gen)
        layer_depth.normal_(generator=gen)
        for t, s in zip((valid, alpha, cutoff), clip_lanes(lanes, seed=i + 1)):
            t.copy_(s.to(dev))
        graph.replay()
        want = worklist_compact_plain(m, gr, cap_g)
        clip_want = worklist_compose_clip_plain(*planes0[:3], want[0], pair_rows, gr, valid,
                                                alpha, cutoff, layer_depth)
        torch.cuda.synchronize()
        for a, b in zip(result, want):
            assert same_bits(a, b)
        assert same_bits(dst, worklist_compose_plain(base, want[0], rows, gr))
        for a, b in zip(planes, clip_want):
            assert same_bits(a, b)
    idx = worklist_compact(mask, gr, cap_g)[0]
    worklist_compose(dst, idx, rows, gr)
    worklist_compose_clip(*planes, idx, pair_rows, gr, valid, alpha, cutoff, layer_depth)
    assert [c.LAUNCHES - b for c, b in zip(counters, before)] == [1, 1, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", (None, 2, 1024))
def test_gr1_compaction_replays_in_a_cuda_graph(blocks):
    """The compaction at gr = 1 and 1080p (the rule's 507 blocks; 2, whose
    runs are many chunks; 1,024, more than the card holds at once, which
    the entry point holds to what it does: a captured grid barrier over
    blocks that never become resident would hang the replay) captured and
    replayed on changed masks: each replay equals the plain version."""
    dev = _card()
    masks = [torch.from_numpy(mask_case(k, 1920, 1080, seed=s)).to(dev)
             for k, s in (("rects", 1), ("dense", 2), ("all_dead", 0))]
    mask = masks[0].clone()
    cap_g = 688128
    worklist_compact(mask, 1, cap_g, blocks)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        result = worklist_compact(mask, 1, cap_g, blocks)
    for m in masks + masks[:1]:
        mask.copy_(m)
        graph.replay()
        want = worklist_compact_plain(m, 1, cap_g)
        torch.cuda.synchronize()
        for a, b in zip(result, want):
            assert same_bits(a, b)


@pytest.mark.gpu
def test_compose_of_no_slots_launches_nothing():
    dev = _card()
    dst = torch.randn((64, 3), device=dev)
    k0 = worklist_compose.LAUNCHES
    out = worklist_compose(dst, torch.zeros((0,), dtype=torch.int32, device=dev),
                           torch.zeros((0, 3), device=dev), 8)
    assert out is dst and worklist_compose.LAUNCHES == k0

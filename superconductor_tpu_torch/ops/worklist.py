"""The shading worklists' compaction and composes (the port of the torch
chains that render/frame.py ran for ``superconductor_tpu/render/frame.py``
``_compact_px`` / ``_compact_worklist``, ``_compose_worklist`` and the
alpha-clip round's takes, masks and composes).

* ``worklist_compact(mask, gr, cap_g)`` -- a flat bool mask (npx,) cut into
  granules of gr pixels -> (idx, safe, live, need): the set granules'
  indices in ascending order, n_g = npx // gr past their count, cap =
  min(cap_g, n_g) of them; safe = min(idx, n_g - 1); live = idx < n_g;
  need = the set granules times gr, a () i32.
* ``worklist_compose(dst, idx, rows, gr, where=None)`` -- writes the lane
  rows (cap * gr,) or (cap * gr, C) into dst (npx,) or (npx, C) at the live
  granules IN PLACE and returns dst; with a lane mask `where`, only the
  lanes whose mask is true write (the same bits as composing
  ``where(ok, rows, take(dst))``, whose other lanes wrote dst's own bits
  back).
* ``worklist_compose_clip(found, pair, depth, idx, rows, gr, valid, alpha,
  cutoff, layer_depth)`` -- one alpha-clip round: at each live lane, cur =
  found != 0 and ok = valid & (alpha >= cutoff) & ~cur; found = cur | ok
  (i32) at every live lane, and where ok pair = the lane's row and depth =
  layer_depth at the pixel; IN PLACE, returns (found, pair, depth).

All three launch csrc/worklist.cu's kernels on CUDA tensors, once a call
(the compaction a cooperative grid of ``compact_blocks`` blocks), and
count them in ``worklist_compact.LAUNCHES``,
``worklist_compose.LAUNCHES`` and ``worklist_compose_clip.LAUNCHES`` as
ops/raster.py's wrappers count theirs. On CPU tensors they run the plain
versions, the torch chains the frame ran before: ``worklist_compact_plain`` (an any() over each granule,
keys, a sort), ``worklist_compose_plain`` (a copy of dst with a scratch row
by torch.cat, index_copy_ into it: it returns a new tensor; the CPU route
of ``worklist_compose`` copies that result into dst) and
``worklist_compose_clip_plain`` (the round's two takes, its masks and
three worklist_compose_plain calls; the CPU route copies its three planes
back). No wrapper falls back: anything a kernel does not take raises.
"""

from __future__ import annotations

import torch

from .raster import _kernel_fn, _launched

# csrc/worklist.cu's compaction: a cooperative grid of compact_blocks(n_g)
# blocks, each flagging its run of granules CHUNK at a time (its kChunk)
GRID_BLOCKS = 128
CHUNK = 4096
_COMPOSE_DTYPES = (torch.float32, torch.int32)


def compact_blocks(n_g: int) -> int:
    """The compaction's grid over n_g granules: GRID_BLOCKS blocks (the
    frames' worklists, 16,200 granules of 128 pixels at 1080p: PERF.md),
    more where a block would own more than CHUNK granules (gr = 1 at 1080p:
    507, faster there than 128 or 254: PERF.md), never more than n_g. The entry point holds it to what the card
    runs at once; a block whose run is longer than CHUNK flags it a chunk
    at a time."""
    return min(n_g, max(GRID_BLOCKS, -(-n_g // CHUNK)))


def worklist_compact_plain(mask: torch.Tensor, gr: int, cap_g: int, blocks=None):
    """worklist_compact's plain version: the granules' any(), then a sort of
    where(granule set, index, n_g) keys (the reference's _compact_px).
    `blocks`, the kernel's grid, changes nothing here: it is taken so that
    either stands in for the other."""
    n = mask.shape[0] // gr
    gmask = mask.reshape(-1, gr).any(dim=1) if gr > 1 else mask
    cap = min(cap_g, n)
    keys = torch.where(
        gmask,
        torch.arange(n, dtype=torch.int32, device=mask.device),
        torch.full((), n, dtype=torch.int32, device=mask.device),
    )
    idx = torch.sort(keys).values[:cap]
    live = idx < n
    safe = torch.clamp_max(idx, n - 1)
    return idx, safe, live, gmask.sum(dtype=torch.int32) * gr


def worklist_compact(mask: torch.Tensor, gr: int, cap_g: int, blocks=None):
    """(idx, safe, live, need) of a contiguous flat bool mask (npx,) in
    granules of gr pixels (npx a multiple of gr), at most cap_g granules
    listed. CUDA tensors launch csrc/worklist.cu worklist_compact_kernel
    once, a cooperative grid of `blocks` blocks (None: compact_blocks; the
    entry point holds it to n_g and to what the card runs at once); CPU
    tensors run worklist_compact_plain. Counts the launch in
    worklist_compact.LAUNCHES."""
    if mask.device.type == "cpu":
        return worklist_compact_plain(mask, gr, cap_g)
    dev = mask.device
    if mask.dtype != torch.bool or mask.dim() != 1 or not mask.is_contiguous():
        raise ValueError(f"worklist_compact: the mask must be a contiguous (npx,) bool tensor, "
                         f"got {mask.dtype} {tuple(mask.shape)}")
    npx = mask.shape[0]
    if gr <= 0 or npx == 0 or npx % gr or npx >= 2 ** 31:
        raise ValueError(f"worklist_compact: {npx} pixels in granules of {gr}")
    n_g = npx // gr
    blocks = compact_blocks(n_g) if blocks is None else int(blocks)
    if blocks <= 0:
        raise ValueError(f"worklist_compact: a grid of {blocks} blocks")
    if dev.type != "cuda":
        raise ValueError(f"worklist_compact: the kernel runs on CUDA tensors, not {dev}")
    cap = max(0, min(int(cap_g), n_g))
    counts = torch.empty((blocks,), dtype=torch.int32, device=dev)
    idx = torch.empty((cap,), dtype=torch.int32, device=dev)
    safe = torch.empty((cap,), dtype=torch.int32, device=dev)
    live = torch.empty((cap,), dtype=torch.bool, device=dev)
    need = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _kernel_fn("sc_worklist_compact")(
            mask.data_ptr(), npx, gr, blocks, cap, counts.data_ptr(), idx.data_ptr(),
            safe.data_ptr(), live.data_ptr(), need.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"worklist compact kernel launch failed: cudaError_t {err}")
    _launched(_COMPACT_COUNTER)
    return idx, safe, live, need


worklist_compact.LAUNCHES = 0
# the wrappers whose LAUNCHES count the kernels' launches, however the
# frame's names for them are rebound (a recording or plain twin put in
# their place)
_COMPACT_COUNTER = worklist_compact


def worklist_compose_plain(dst: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, gr: int,
                           where=None) -> torch.Tensor:
    """worklist_compose's plain version, which returns a new tensor: dst
    copied with one scratch row by torch.cat, the rows (with `where`,
    where(where, rows, dst's own rows at the lanes)) index_copy_'d in at
    idx (a dead slot's idx is the scratch row, sliced off)."""
    c = 1 if dst.ndim == 1 else dst.shape[-1]
    ng = dst.shape[0] // gr
    if where is not None:
        cur = dst.reshape(-1, gr * c)[torch.clamp_max(idx, ng - 1)].reshape(rows.shape)
        rows = torch.where(where if rows.ndim == 1 else where[:, None], rows, cur)
    out = torch.cat([dst.reshape(ng, gr * c), dst.new_zeros((1, gr * c))])
    out.index_copy_(0, idx.long(), rows.reshape(-1, gr * c).to(dst.dtype))
    return out[:ng].reshape(dst.shape)


def worklist_compose(dst: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, gr: int,
                     where=None) -> torch.Tensor:
    """Write the lane rows (len(idx) * gr,) or (len(idx) * gr, C) into dst
    (npx,) or (npx, C), f32 or i32, at the granules idx (i32, n_g = npx //
    gr or more: dead) IN PLACE, and return dst; with `where` (len(idx) *
    gr,) bool, only the lanes whose mask is true. CUDA tensors launch
    csrc/worklist.cu worklist_compose_kernel once (rows and dst of the same
    dtype, everything contiguous); CPU tensors copy worklist_compose_plain's
    result into dst. Counts its launches in worklist_compose.LAUNCHES."""
    if dst.device.type == "cpu":
        return dst.copy_(worklist_compose_plain(dst, idx, rows, gr, where))
    dev = dst.device
    if dst.dim() not in (1, 2) or dst.dtype not in _COMPOSE_DTYPES or not dst.is_contiguous():
        raise ValueError(f"worklist_compose: dst must be a contiguous (npx,) or (npx, C) f32 or "
                         f"i32 tensor, got {dst.dtype} {tuple(dst.shape)}")
    c = 1 if dst.dim() == 1 else dst.shape[1]
    if gr <= 0 or dst.shape[0] == 0 or dst.shape[0] % gr or c == 0:
        raise ValueError(f"worklist_compose: {dst.shape[0]} pixels of {c} words in granules "
                         f"of {gr}")
    if idx.device != dev or idx.dtype != torch.int32 or idx.dim() != 1 \
            or not idx.is_contiguous():
        raise ValueError(f"worklist_compose: idx must be a contiguous (slots,) int32 tensor on "
                         f"{dev}, got {idx.dtype} {tuple(idx.shape)} on {idx.device}")
    slots = idx.shape[0]
    want = (slots * gr,) + tuple(dst.shape[1:])
    if rows.device != dev or rows.dtype != dst.dtype or tuple(rows.shape) != want \
            or not rows.is_contiguous():
        raise ValueError(f"worklist_compose: rows must be a contiguous {want} {dst.dtype} "
                         f"tensor on {dev}, got {rows.dtype} {tuple(rows.shape)} on "
                         f"{rows.device}")
    if where is not None and (where.device != dev or where.dtype != torch.bool
                              or tuple(where.shape) != (slots * gr,)
                              or not where.is_contiguous()):
        raise ValueError(f"worklist_compose: where must be a contiguous ({slots * gr},) bool "
                         f"tensor on {dev}, got {where.dtype} {tuple(where.shape)} on "
                         f"{where.device}")
    if dev.type != "cuda":
        raise ValueError(f"worklist_compose: the kernel runs on CUDA tensors, not {dev}")
    if slots == 0:
        return dst
    with torch.cuda.device(dev):
        err = _kernel_fn("sc_worklist_compose")(
            idx.data_ptr(), slots, gr, c, dst.shape[0] // gr, rows.data_ptr(),
            None if where is None else where.data_ptr(), dst.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"worklist compose kernel launch failed: cudaError_t {err}")
    _launched(_COMPOSE_COUNTER)
    return dst


worklist_compose.LAUNCHES = 0
_COMPOSE_COUNTER = worklist_compose


def _take(x: torch.Tensor, safe: torch.Tensor, gr: int) -> torch.Tensor:
    """A flat per-pixel plane (npx,) gathered to worklist lanes, one granule
    row at a time (render/frame.py _Worklist.take)."""
    return x[safe] if gr == 1 else x.reshape(-1, gr)[safe].reshape(-1)


def worklist_compose_clip_plain(found: torch.Tensor, pair: torch.Tensor, depth: torch.Tensor,
                                idx: torch.Tensor, rows: torch.Tensor, gr: int,
                                valid: torch.Tensor, alpha: torch.Tensor, cutoff: torch.Tensor,
                                layer_depth: torch.Tensor) -> tuple:
    """worklist_compose_clip's plain version, the clip round's torch chain
    op for op, which returns new planes: the takes of found and of
    layer_depth at safe = min(idx, n_g - 1), cur = take(found) != 0, ok =
    valid & (alpha >= cutoff) & ~cur, then worklist_compose_plain of (cur |
    ok) as i32 into found, of rows into pair where ok and of
    take(layer_depth) into depth where ok."""
    safe = torch.clamp_max(idx, found.shape[0] // gr - 1)
    cur_found = _take(found, safe, gr) != 0
    ok = valid & (alpha >= cutoff) & ~cur_found
    return (worklist_compose_plain(found, idx, (cur_found | ok).to(torch.int32), gr),
            worklist_compose_plain(pair, idx, rows, gr, where=ok),
            worklist_compose_plain(depth, idx, _take(layer_depth, safe, gr), gr, where=ok))


def _check_plane(t: torch.Tensor, name: str, dtype, npx: int, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != (npx,) \
            or not t.is_contiguous():
        raise ValueError(f"worklist_compose_clip: {name} must be a contiguous ({npx},) {dtype} "
                         f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_lanes(t: torch.Tensor, name: str, dtype, lanes: int, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != (lanes,):
        raise ValueError(f"worklist_compose_clip: {name} must be a ({lanes},) {dtype} tensor "
                         f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def worklist_compose_clip(found: torch.Tensor, pair: torch.Tensor, depth: torch.Tensor,
                          idx: torch.Tensor, rows: torch.Tensor, gr: int, valid: torch.Tensor,
                          alpha: torch.Tensor, cutoff: torch.Tensor,
                          layer_depth: torch.Tensor) -> tuple:
    """One alpha-clip round's compose IN PLACE -> (found, pair, depth). At
    each live slot j's lanes q = j * gr + l, pixel p = idx[j] * gr + l: cur =
    found[p] != 0, ok = valid[q] & (alpha[q] >= cutoff[q]) & ~cur; found[p]
    = cur | ok as i32 (every live lane), and where ok pair[p] = rows[q] and
    depth[p] = layer_depth[p]; dead slots write nothing. found, pair (npx,)
    i32, depth and layer_depth (npx,) f32, all contiguous; idx (slots,) i32
    and rows (slots * gr,) i32 contiguous; valid (slots * gr,) bool, alpha
    and cutoff (slots * gr,) f32 at any stride (ops/shade.py albedo_alpha's
    columns as they are). CUDA tensors launch csrc/worklist.cu
    worklist_compose_kernel once; CPU tensors copy
    worklist_compose_clip_plain's planes into found, pair and depth. Counts
    its launches in worklist_compose_clip.LAUNCHES."""
    planes = (found, pair, depth)
    if found.device.type == "cpu":
        out = worklist_compose_clip_plain(found, pair, depth, idx, rows, gr, valid, alpha,
                                          cutoff, layer_depth)
        return tuple(t.copy_(o) for t, o in zip(planes, out))
    dev = found.device
    npx = found.shape[0] if found.dim() == 1 else -1
    if gr <= 0 or npx <= 0 or npx % gr:
        raise ValueError(f"worklist_compose_clip: found {tuple(found.shape)} in granules of {gr}")
    for t, name, dtype in ((found, "found", torch.int32), (pair, "pair", torch.int32),
                           (depth, "depth", torch.float32),
                           (layer_depth, "layer_depth", torch.float32)):
        _check_plane(t, name, dtype, npx, dev)
    if idx.device != dev or idx.dtype != torch.int32 or idx.dim() != 1 \
            or not idx.is_contiguous():
        raise ValueError(f"worklist_compose_clip: idx must be a contiguous (slots,) int32 tensor "
                         f"on {dev}, got {idx.dtype} {tuple(idx.shape)} on {idx.device}")
    lanes = idx.shape[0] * gr
    for t, name, dtype in ((rows, "rows", torch.int32), (valid, "valid", torch.bool),
                           (alpha, "alpha", torch.float32), (cutoff, "cutoff", torch.float32)):
        _check_lanes(t, name, dtype, lanes, dev)
    if not rows.is_contiguous():
        raise ValueError("worklist_compose_clip: rows must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"worklist_compose_clip: the kernel runs on CUDA tensors, not {dev}")
    if lanes == 0:
        return planes
    with torch.cuda.device(dev):
        err = _kernel_fn("sc_worklist_compose_clip")(
            idx.data_ptr(), idx.shape[0], gr, npx // gr, valid.data_ptr(), valid.stride(0),
            alpha.data_ptr(), alpha.stride(0), cutoff.data_ptr(), cutoff.stride(0),
            rows.data_ptr(), layer_depth.data_ptr(), found.data_ptr(), pair.data_ptr(),
            depth.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"worklist compose kernel (clip round) launch failed: cudaError_t {err}")
    _launched(_COMPOSE_CLIP_COUNTER)
    return planes


worklist_compose_clip.LAUNCHES = 0
_COMPOSE_CLIP_COUNTER = worklist_compose_clip

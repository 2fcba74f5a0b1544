"""Scene tables on the torch device: the port's "weights carried across".

``scene_to_torch`` builds the same dict as the reference's
``Scene.device_arrays()`` (superconductor_tpu/scene/scene.py:1390) from the
host ``Scene``'s numpy tables, without jax: the vertex/index mega-buffers
and texel pools at full capacity (``GrowableArray.host``), the descriptor
and material tables (host-side ``descriptor_arrays`` / ``material_arrays``
plus the numpy post-processing of ``device_materials``, :638-700), the
quad-packed pools (``device_quad``, :187) and the interleaved material pool
(``device_matq``, :1072-1241, the wide mq3 rows included), the SH-interleaved light
volume and lightmap pools (``device_lightvol_sh`` / ``device_lightmap_sh``,
:1314-1388) and the smoke pool (``device_smoke``, :1242-1283). The quad,
matq, SH and smoke pools are row gathers, done here as torch gathers on
``device``, and published only where the reference publishes them: under
``quad_pools``.

The one representation change: the u32 index buffers are carried as i32
(same bits; every index is far below 2**31), because torch has no gather
kernels for unsigned 32-bit tensors.

A partial interleaved pool (some materials incapable) is published as the
reference publishes it: incapable materials' ``mat_row_mq`` rows carry
their real factors and a count=0 sentinel, and ``matq_capable`` (M,) bool
marks the capable ones for the material-path partition.

``DeviceScene`` keeps the same dict resident across frames and uploads
only what changed (the app loop calls it every frame, where the
reference calls ``Scene.device_arrays()``); ``scene_to_torch`` rebuilds
everything and is the oracle it is tested against.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from .scene import WRAP_REPEAT, Scene

_VERTEX_KEYS = (
    "positions", "normals", "uvs", "lightmap_uvs", "indices", "tri_material",
    "anim_positions", "anim_normals", "anim_uvs", "anim_joint_indices",
    "anim_joint_weights", "anim_indices", "anim_tri_material",
)


def _np_to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    # always a copy: the tensor never aliases the Scene's host mirror
    return torch.tensor(a, device=device)


def arrays_to_torch(tree, device="cuda"):
    """Convert a (nested dict of) numpy / jax arrays -- e.g. the
    reference's ``Scene.device_arrays()`` -- to torch tensors on
    ``device``, keeping every key and dtype (u32 carried as i32 bits)."""
    if isinstance(tree, dict):
        return {k: arrays_to_torch(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    return _np_to_torch(np.asarray(tree), device)


def material_tables(scene: Scene) -> dict:
    """Numpy material tables exactly as ``Scene.device_materials`` builds
    them (scene.py:638-700): material_arrays + mat_tex_meta + mat_row."""
    arrays = scene.material_arrays()
    pool = scene.textures
    d = pool.descriptor_arrays()
    tm = np.concatenate(
        [d["tex_meta"], d["mip_owh"][d["tex_meta"][:, 0]][:, 1:3]], axis=1
    )
    ids = arrays["packed_i"][:, 0:4].astype(np.int64)
    arrays["mat_tex_meta"] = tm[ids].reshape(ids.shape[0], 24)
    counts_full = [
        pool._full_view[t][1] if t in pool._full_view else pool.tex_mip_count[t]
        for t in range(pool.num_textures)
    ]
    L = max(counts_full) if counts_full else 1
    base = d["tex_meta"][:, 0:1]
    count = d["tex_meta"][:, 1:2]
    lvl = np.minimum(np.arange(L)[None, :], count - 1)
    tab = d["mip_owh"][base + lvl][:, :, 0:3]
    mat_levels = tab[ids].reshape(ids.shape[0], 4 * L * 3)
    arrays["mat_row"] = np.concatenate(
        [
            arrays["packed_f"],
            arrays["packed_i"].view(np.float32),
            arrays["mat_tex_meta"].astype(np.int32).view(np.float32),
            mat_levels.astype(np.int32).view(np.float32),
        ],
        axis=1,
    )
    return arrays


def _quad(t: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    n = nbr.long()
    return torch.cat([t, t[n[:, 0]], t[n[:, 1]], t[n[:, 2]]], dim=1)


def quad_pool(pool, device) -> torch.Tensor:
    """(N, 16) quad-packed pool (TexturePool.device_quad, scene.py:187):
    row i = [t[i], t[right], t[down], t[diag]], wrap baked in."""
    if pool.nbr.capacity < pool.texels.capacity:
        pool.nbr._ensure(pool.texels.capacity)
    return _quad(_np_to_torch(pool.texels.host, device),
                 _np_to_torch(pool.nbr.host, device))


def _is_const(pool, t: int) -> bool:
    base, count = pool.tex_mip_base[t], pool.tex_mip_count[t]
    return count == 1 and pool.mip_w[base] == 1 and pool.mip_h[base] == 1


def _fill_slot_index(idx: np.ndarray, pool, ids, dims, offsets) -> None:
    """Write one chain's quad-pool rows into idx (4, rows): per interleaved
    row and material slot (device_matq's index build, scene.py:1100-1115
    and :1182-1196). Levels with a negative offset are skipped."""
    for l, (h, w) in enumerate(dims):
        off = offsets[l]
        if off < 0:
            continue
        for s, t in enumerate(ids):
            base = pool.tex_mip_base[t]
            if _is_const(pool, t):
                idx[s, off:off + h * w] = pool.mip_offset[base]
            else:
                idx[s, off:off + h * w] = pool.mip_offset[base + l] + np.arange(
                    h * w, dtype=np.int32
                )


def _fill_mq3_index(idx3: np.ndarray, pool, ids, dims, wrap, offsets) -> None:
    """Write one chain's texel-pool rows into idx3 (4, 9, rows): per level-l
    texel (y, x) and slot, the 3x3 of level l + 1 around (y >> 1, x >> 1)
    (the last level pairs with itself: around (y, x)), wrap baked in --
    the level-b footprint of the mq3 trilinear (device_matq, scene.py:
    1117-1149)."""
    count = len(dims)
    for l, (h, w) in enumerate(dims):
        off = offsets[l]
        lb = l + 1 if l + 1 < count else l
        hb, wb = dims[lb]
        y, x = np.mgrid[0:h, 0:w].astype(np.int32)
        cy = (y >> 1) if lb != l else y
        cx = (x >> 1) if lb != l else x
        for dy in range(3):
            for dx in range(3):
                ys, xs = cy + dy - 1, cx + dx - 1
                if wrap == WRAP_REPEAT:
                    ys, xs = ys % hb, xs % wb
                else:
                    ys, xs = np.clip(ys, 0, hb - 1), np.clip(xs, 0, wb - 1)
                flat = (ys * wb + xs).reshape(-1)
                for s, t in enumerate(ids):
                    if _is_const(pool, t):
                        idx3[s, dy * 3 + dx, off:off + h * w] = pool.mip_offset[pool.tex_mip_base[t]]
                    else:
                        idx3[s, dy * 3 + dx, off:off + h * w] = (
                            pool.mip_offset[pool.tex_mip_base[t] + lb] + flat
                        )


def matq_tables(scene: Scene, quad: torch.Tensor, texels: torch.Tensor, device):
    """(texels_mq, texels_mq_tail or None, mat_row_mq (M, 24+4L) f32,
    matq_capable (M,) bool or None) or None -- Scene.device_matq
    (scene.py:1072-1241); matq_capable only for a partial pool
    (scene.py:1428-1438). texels_mq is (N, 64) u8 quad rows with a tail
    pool, or, when scene.matq3x3 and the plan's mq3_ok, the wide (N, 208)
    u8 mq3 rows (the four slots' quad rows of level l, then for each slot
    the 3x3 texels of level l + 1 from `texels`, the (T, 4) u8 pool) with
    no tail pool."""
    if not (scene.quad_pools and scene.matq_pools):
        return None
    plan = scene.matq_plan()
    if plan is None:
        return None
    for ids, _, _ in plan["chains"]:
        if any(t in scene.textures._full_view for t in ids):
            return None
    mq3 = scene.matq3x3 and plan["mq3_ok"]
    pool = scene.textures

    def gather(idx: np.ndarray) -> torch.Tensor:
        i = torch.from_numpy(idx).to(device).long()
        return torch.cat([quad[i[0]], quad[i[1]], quad[i[2]], quad[i[3]]], dim=1)

    total = plan["total_rows"]
    idx = np.empty((4, total), np.int32)
    for c, (ids, dims, _) in enumerate(plan["chains"]):
        _fill_slot_index(idx, pool, ids, dims, plan["offsets"][c])
    texels_mq = gather(idx)
    if mq3:
        idx3 = np.empty((4, 9, total), np.int32)
        for c, (ids, dims, wrap) in enumerate(plan["chains"]):
            _fill_mq3_index(idx3, pool, ids, dims, wrap, plan["offsets"][c])
        i3 = torch.from_numpy(idx3.reshape(36, total)).to(device).long()
        texels_mq = torch.cat([texels_mq, *(texels[i3[r]] for r in range(36))], dim=1)

    texels_mq_tail = None
    if not mq3 and plan["tail_total"] > 0:
        idx_t = np.empty((4, plan["tail_total"]), np.int32)
        for c, (ids, dims, _) in enumerate(plan["chains"]):
            _fill_slot_index(idx_t, pool, ids, dims, plan["tail_offsets"][c])
        texels_mq_tail = gather(idx_t)

    arrays = scene.material_arrays()
    L = plan["L"]
    mrows = []
    for mi, c in enumerate(plan["mat_chain"]):
        owh = np.zeros((L, 4), np.int32)
        if c < 0:
            # incapable material: count=0 sentinel, zero offsets, 1x1 dims
            meta = np.array([WRAP_REPEAT, 0, 0, 0], np.int32)
            owh[:, 1:3] = 1
        else:
            _, dims, wrap = plan["chains"][c]
            meta = np.array([wrap, plan["srgb_masks"][c], len(dims), 0], np.int32)
            for l in range(L):
                ll = min(l, len(dims) - 1)
                h, w = dims[ll]
                owh[l] = (plan["offsets"][c][ll], w, h, plan["tail_offsets"][c][ll])
        mrows.append(
            np.concatenate(
                [
                    arrays["packed_f"][mi],
                    arrays["packed_i"][mi].view(np.float32),
                    meta.view(np.float32),
                    owh.reshape(-1).view(np.float32),
                ]
            )
        )
    mat_row_mq = _np_to_torch(np.stack(mrows).astype(np.float32), device)
    capable = None
    if plan["partial"]:
        capable = _np_to_torch(np.asarray(plan["mat_capable"], np.bool_), device)
    return texels_mq, texels_mq_tail, mat_row_mq, capable


def sh_pool(pool, texels: torch.Tensor, tex_ids, z: int) -> torch.Tensor:
    """(w*h*z, 48) f16 SH-interleaved pool of four same-sized HDR textures
    whose z layers are stored as consecutive mip entries (Scene._device_sh_pool,
    scene.py:1314-1358): row (z*h*w + y*w + x) holds the rgb of the texel's
    2x2 bilinear footprint in all four textures, corner-major ([t00: L0 Lx
    Ly Lz][t10][t01][t11]), clamp wrap baked in. `texels` is the HDR pool
    on the device."""
    base0 = pool.tex_mip_base[tex_ids[0]]
    w, h = pool.mip_w[base0], pool.mip_h[base0]
    x = np.arange(w, dtype=np.int32)
    y = np.arange(h, dtype=np.int32)
    xc = np.minimum(x + 1, w - 1)
    yc = np.minimum(y + 1, h - 1)
    cols = []
    for cx, cy in ((x, y), (xc, y), (x, yc), (xc, yc)):
        grid = cy[:, None] * w + cx[None, :]  # (h, w)
        for t in tex_ids:
            base = pool.tex_mip_base[t]
            if pool.tex_mip_count[t] != z or (pool.mip_w[base], pool.mip_h[base]) != (w, h):
                raise ValueError(f"SH texture {t} does not match {w}x{h}x{z}")
            offs = np.asarray(pool.mip_offset[base:base + z], np.int32)
            cols.append((offs[:, None, None] + grid[None]).reshape(-1))
    idx = torch.from_numpy(np.stack(cols)).to(texels.device).long()  # (16, w*h*z)
    return torch.cat([texels[idx[k]][:, :3] for k in range(16)], dim=1)


def smoke_tables(scene: Scene, quad: torch.Tensor):
    """(smoke_ab (w*h, 32) u8, smoke_lut (lw*lh, 16) u8) or None
    (Scene.device_smoke, scene.py:1242-1283): both smoke maps' level-0 quad
    rows side by side, and the LUT's own quad rows. None where the
    reference publishes none: no smoke textures, or smoke maps whose
    level-0 dims or wrap differ (then smoke_static_dims is None too)."""
    dims = scene.smoke_static_dims()
    if dims is None:
        return None
    pool = scene.textures
    a, b, lut = (pool.tex_mip_base[t] for t in scene.smoke_tex)
    w, h, lw, lh = dims[0], dims[1], dims[3], dims[4]

    def rows(base, n):
        i = pool.mip_offset[base] + torch.arange(n, device=quad.device)
        return quad[i]

    return torch.cat([rows(a, w * h), rows(b, w * h)], dim=1), rows(lut, lw * lh)


def scene_to_torch(scene: Scene, device="cuda") -> dict:
    """The reference's ``Scene.device_arrays()`` dict, built from the host
    tables as torch tensors on ``device``."""
    scene.enforce_texture_budget()
    d = {k: _np_to_torch(getattr(scene, k).host, device) for k in _VERTEX_KEYS}
    d["texels"] = _np_to_torch(scene.textures.texels.host, device)
    d["texels_hdr"] = _np_to_torch(scene.textures_hdr.texels.host, device)
    materials = {
        k: _np_to_torch(v, device) for k, v in material_tables(scene).items()
    }
    d["materials"] = materials
    d["tex"] = arrays_to_torch(scene.textures.descriptor_arrays(), device)
    d["tex_hdr"] = arrays_to_torch(scene.textures_hdr.descriptor_arrays(), device)
    if scene.quad_pools:
        quad = quad_pool(scene.textures, device)
        d["texels_q"] = quad
        d["texels_hdr_q"] = quad_pool(scene.textures_hdr, device)
        if scene.lightvol is not None:
            d["lv_sh"] = sh_pool(scene.textures_hdr, d["texels_hdr"],
                                 scene.lightvol["tex_ids"], scene.lightvol["z_layers"])
        if scene.lightmap_tex is not None:
            d["lm_sh"] = sh_pool(scene.textures_hdr, d["texels_hdr"], scene.lightmap_tex, 1)
        mq: Optional[tuple] = matq_tables(scene, quad, d["texels"], device)
        if mq is not None:
            d["texels_mq"] = mq[0]
            if mq[1] is not None:
                d["texels_mq_tail"] = mq[1]
            d["materials"] = dict(materials)
            d["materials"]["mat_row_mq"] = mq[2]
            if mq[3] is not None:
                d["matq_capable"] = mq[3]
        smoke = smoke_tables(scene, quad)
        if smoke is not None:
            d["smoke_ab"], d["smoke_lut"] = smoke
    return d


class DeviceScene:
    """``scene_to_torch(scene, device)``'s dict, kept resident on
    ``device`` across frames (the reference's cached
    ``Scene.device_arrays()``, scene.py:1390-1442).

    ``arrays()`` uploads only what changed since its last call:

      * each vertex, index and texel buffer keeps its tensor; the rows of
        its dirty range (``GrowableArray.take_dirty``) are copied into it
        in place, and a capacity change (a growth) uploads the buffer
        whole into a new tensor (the reference's ``GrowableArray.device``,
        buffers.py:117);
      * the descriptor tables of a texture pool are rebuilt when its
        ``_desc_dirty`` is set, the material tables when
        ``Scene._materials_dirty`` is set or the LDR descriptors were
        rebuilt (``device_materials``, scene.py:638);
      * the quad, SH (``lv_sh``, ``lm_sh``), interleaved-material and
        smoke pools are gathered on the device again only when one of
        their inputs changed (the reference's keyed caches: ``device_quad``
        :187, ``device_matq`` :1072, ``device_smoke`` :1242,
        ``device_lightvol_sh`` / ``device_lightmap_sh`` :1360-1388).

    The dirty state goes to one DeviceScene: the one made last on the
    scene (``scene._device_scene``), which uploads everything on its first
    call; an earlier one raises when called again. ``bytes_uploaded`` counts host-to-device bytes (cumulative) and
    ``last_upload`` the bytes of the last call by key; ``rebuilds`` counts
    the derived pools' device rebuilds by key.
    """

    def __init__(self, scene: Scene, device="cuda"):
        self.scene = scene
        scene._device_scene = self
        self.device = torch.device(device)
        self._res: dict = {}  # buffer key -> resident tensor
        self._ver: collections.Counter = collections.Counter()  # key -> changes
        # the pools' descriptor tables (by texel key) and the material tables
        self._tables: dict = {}
        self._derived: dict = {}  # pool key -> (input change counts, value)
        self.bytes_uploaded = 0
        self.last_upload: dict = {}
        self.rebuilds: collections.Counter = collections.Counter()

    def _count(self, key: str, nbytes: int) -> None:
        self.bytes_uploaded += nbytes
        self.last_upload[key] = self.last_upload.get(key, 0) + nbytes
        self._ver[key] += 1

    def _buffer(self, key: str, arr) -> torch.Tensor:
        lo, hi = arr.take_dirty()
        t = self._res.get(key)
        if t is None or t.shape[0] != arr.capacity or hi - lo >= arr.capacity:
            t = self._res[key] = _np_to_torch(arr.host, self.device)
            self._count(key, arr.host.nbytes)
        elif hi > lo:
            rows = arr.host[lo:hi]
            if rows.dtype == np.uint32:
                rows = rows.view(np.int32)
            t[lo:hi].copy_(torch.from_numpy(rows))
            self._count(key, rows.nbytes)
        return t

    def _pool_buffers(self, prefix: str, pool):
        if pool.nbr.capacity < pool.texels.capacity:
            pool.nbr._ensure(pool.texels.capacity)
        texels = self._buffer(prefix, pool.texels.array)
        nbr = self._buffer(prefix + "_nbr", pool.nbr)
        if pool._desc_dirty or prefix not in self._tables:
            tables = pool.descriptor_arrays()
            self._tables[prefix] = arrays_to_torch(tables, self.device)
            pool._desc_dirty = False
            self._count("tex" + prefix[len("texels"):],
                        sum(a.nbytes for a in tables.values()))
        return texels, nbr

    def _pool(self, key: str, inputs: tuple, build):
        """The derived pool `key`, rebuilt by build() when `inputs` (the
        change counts of what it is gathered from) moved."""
        hit = self._derived.get(key)
        if hit is None or hit[0] != inputs:
            hit = self._derived[key] = (inputs, build())
            self._ver[key] += 1
            self.rebuilds[key] += 1
        return hit[1]

    def arrays(self) -> dict:
        scene, dev = self.scene, self.device
        if scene._device_scene is not self:
            raise RuntimeError("a newer DeviceScene took this scene's dirty state")
        self.last_upload = {}
        scene.enforce_texture_budget()
        d = {k: self._buffer(k, getattr(scene, k).array) for k in _VERTEX_KEYS}
        d["texels"], nbr = self._pool_buffers("texels", scene.textures)
        d["texels_hdr"], nbr_hdr = self._pool_buffers("texels_hdr", scene.textures_hdr)
        ver = self._ver
        # the material rows snapshot the LDR descriptors (mat_tex_meta)
        if scene._materials_dirty or self._tables.get("materials_tex") != ver["tex"]:
            tables = material_tables(scene)
            self._tables["materials"] = {k: _np_to_torch(v, dev) for k, v in tables.items()}
            self._tables["materials_tex"] = ver["tex"]
            scene._materials_dirty = False
            self._count("materials", sum(a.nbytes for a in tables.values()))
        materials = self._tables["materials"]
        d["materials"] = materials
        d["tex"] = self._tables["texels"]
        d["tex_hdr"] = self._tables["texels_hdr"]
        if scene.quad_pools:
            quad = self._pool("texels_q", (ver["texels"], ver["texels_nbr"]),
                              lambda: _quad(d["texels"], nbr))
            d["texels_q"] = quad
            d["texels_hdr_q"] = self._pool(
                "texels_hdr_q", (ver["texels_hdr"], ver["texels_hdr_nbr"]),
                lambda: _quad(d["texels_hdr"], nbr_hdr))
            hdr_in = (ver["texels_hdr"], ver["tex_hdr"])
            if scene.lightvol is not None:
                lv = scene.lightvol
                d["lv_sh"] = self._pool(
                    "lv_sh", hdr_in + (tuple(lv["tex_ids"]), lv["z_layers"]),
                    lambda: sh_pool(scene.textures_hdr, d["texels_hdr"],
                                    lv["tex_ids"], lv["z_layers"]))
            if scene.lightmap_tex is not None:
                d["lm_sh"] = self._pool(
                    "lm_sh", hdr_in + (tuple(scene.lightmap_tex),),
                    lambda: sh_pool(scene.textures_hdr, d["texels_hdr"],
                                    scene.lightmap_tex, 1))
            mq = self._pool(
                "matq", (ver["texels_q"], ver["tex"], ver["materials"],
                         scene.matq_pools, scene.matq3x3),
                lambda: matq_tables(scene, quad, d["texels"], dev))
            if mq is not None:
                d["texels_mq"] = mq[0]
                if mq[1] is not None:
                    d["texels_mq_tail"] = mq[1]
                d["materials"] = dict(materials)
                d["materials"]["mat_row_mq"] = mq[2]
                if mq[3] is not None:
                    d["matq_capable"] = mq[3]
            smoke = self._pool(
                "smoke", (ver["texels_q"], ver["tex"], tuple(scene.smoke_tex)),
                lambda: smoke_tables(scene, quad))
            if smoke is not None:
                d["smoke_ab"], d["smoke_lut"] = smoke
        return d


__all__ = ["DeviceScene", "arrays_to_torch", "material_tables", "scene_to_torch"]

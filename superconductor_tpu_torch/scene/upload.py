"""Scene tables on the torch device: the port's "weights carried across".

``scene_to_torch`` builds the same dict as the reference's
``Scene.device_arrays()`` (superconductor_tpu/scene/scene.py:1390) from the
host ``Scene``'s numpy tables, without jax: the vertex/index mega-buffers
and texel pools at full capacity (``GrowableArray.host``), the descriptor
and material tables (host-side ``descriptor_arrays`` / ``material_arrays``
plus the numpy post-processing of ``device_materials``, :638-700), the
quad-packed pools (``device_quad``, :187) and the interleaved material pool
(the non-mq3 path of ``device_matq``, :1072-1241), the SH-interleaved light
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

The wide mq3 rows are outside the port and raise NotImplementedError
instead of rendering wrong.
"""

from __future__ import annotations

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


def quad_pool(pool, device) -> torch.Tensor:
    """(N, 16) quad-packed pool (TexturePool.device_quad, scene.py:187):
    row i = [t[i], t[right], t[down], t[diag]], wrap baked in."""
    if pool.nbr.capacity < pool.texels.capacity:
        pool.nbr._ensure(pool.texels.capacity)
    t = _np_to_torch(pool.texels.host, device)
    n = _np_to_torch(pool.nbr.host, device).long()
    return torch.cat([t, t[n[:, 0]], t[n[:, 1]], t[n[:, 2]]], dim=1)


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


def matq_tables(scene: Scene, quad: torch.Tensor, device):
    """(texels_mq (N, 64) u8, texels_mq_tail or None, mat_row_mq (M, 24+4L)
    f32, matq_capable (M,) bool or None) or None -- the non-mq3 path of
    Scene.device_matq (scene.py:1072-1241); matq_capable only for a
    partial pool (scene.py:1428-1438)."""
    if not (scene.quad_pools and scene.matq_pools):
        return None
    plan = scene.matq_plan()
    if plan is None:
        return None
    for ids, _, _ in plan["chains"]:
        if any(t in scene.textures._full_view for t in ids):
            return None
    if scene.matq3x3 and plan["mq3_ok"]:
        raise NotImplementedError(
            "wide mq3 interleaved rows are not ported (ROADMAP: do not port)"
        )
    pool = scene.textures

    def gather(idx: np.ndarray) -> torch.Tensor:
        i = torch.from_numpy(idx).to(device).long()
        return torch.cat([quad[i[0]], quad[i[1]], quad[i[2]], quad[i[3]]], dim=1)

    idx = np.empty((4, plan["total_rows"]), np.int32)
    for c, (ids, dims, _) in enumerate(plan["chains"]):
        _fill_slot_index(idx, pool, ids, dims, plan["offsets"][c])
    texels_mq = gather(idx)

    texels_mq_tail = None
    if plan["tail_total"] > 0:
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
        mq: Optional[tuple] = matq_tables(scene, quad, device)
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


__all__ = ["arrays_to_torch", "material_tables", "scene_to_torch"]

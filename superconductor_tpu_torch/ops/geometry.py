"""Geometry stage: draw expansion, vertex transform/skinning, homogeneous
triangle setup -- the port of ``superconductor_tpu/ops/geometry.py``.

Same data model as the reference: a (T, 16) f32 setup row per triangle
pair, [a0,b0,c0, a1,b1,c1, a2,b2,c2, zc0,zc1,zc2, wc0,wc1,wc2, flags], with
edge i evaluated as e_i(px, py) = a_i*px + b_i*py + c_i, plus a packed (T,
32) attribute row for the deferred stages. Integer tensors stay i32 at
every public boundary.

Two places where torch and jax differ and the port chooses on purpose:

* ``jnp.repeat(..., total_repeat_length=cap)`` becomes
  ``searchsorted(cumsum(counts), arange(cap), right=True)`` -- identical
  output for any total, including total != cap;
* the per-view clip transform (reference: ``w1 @ view_proj.T``) is written
  as explicit multiply-adds in a fixed order, so no library matmul (and no
  TF32) decides its rounding. A one-ulp change in a clip coordinate moves
  an edge coefficient by up to a few percent (the coefficients are
  differences of near-equal products), so the order matters: it is the
  one XLA's CPU dot uses, which makes the setup rows bit-exact.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..math3d import quat_rotate, similarity_apply

FLAG_BACKFACING = 1.0


def device_values(values, dtype, device) -> torch.Tensor:
    """torch.tensor(values, dtype=dtype, device=device), the same numbers,
    made on a CUDA device by one fill a value: a copy from pageable host
    memory synchronises with the host, and a CUDA graph cannot capture it."""
    host = torch.tensor(values, dtype=dtype)
    flat = [torch.full((), v, dtype=dtype, device=device) for v in host.reshape(-1).tolist()]
    return torch.stack(flat).reshape(host.shape)


class DrawList(NamedTuple):
    """One pass's instances padded to a static capacity (reference
    DrawList, ops/geometry.py:44): sim8 (N, 8) f32; first_tri, tri_count,
    first_vertex, vertex_count, joints_offset, material (N,) i32;
    lightmapped, valid (N,) bool."""

    sim8: torch.Tensor
    first_tri: torch.Tensor
    tri_count: torch.Tensor
    first_vertex: torch.Tensor
    vertex_count: torch.Tensor
    joints_offset: torch.Tensor
    material: torch.Tensor
    lightmapped: torch.Tensor
    valid: torch.Tensor


class TriangleSetup(NamedTuple):
    setup: torch.Tensor  # (T, 16) f32
    tri_id: torch.Tensor  # (T,) i32 scene triangle id
    inst_id: torch.Tensor  # (T,) i32 row into the DrawList
    bbox: torch.Tensor  # (T, 4) i32 [x0, y0, x1, y1] inclusive pixels
    valid: torch.Tensor  # (T,) bool
    num_valid: torch.Tensor  # () i32


class TriangleAttrs(NamedTuple):
    world_pos: torch.Tensor  # (T, 3, 3)
    normal: torch.Tensor  # (T, 3, 3)
    uv: torch.Tensor  # (T, 3, 2)
    lm_uv: torch.Tensor  # (T, 3, 2)
    material: torch.Tensor  # (T,) i32
    lightmapped: torch.Tensor  # (T,) bool
    # world_pos(9) | normal(9) | uv(6) | lm_uv(6) | material (i32 bits) |
    # lightmapped -- see pack_attrs
    packed: Optional[torch.Tensor] = None


def ragged_owner(counts: torch.Tensor, cap: int) -> tuple:
    """Expansion of per-row counts into `cap` slots: (owner (cap,) i32,
    slot_valid (cap,) bool, offsets (n,) i32, total () i32). owner[p] is
    the row whose range holds slot p (0 where p >= total), the port of
    ``jnp.repeat(arange(n), counts, total_repeat_length=cap)``."""
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    offsets = ends - counts
    total = counts.sum(dtype=torch.int32)
    pos = torch.arange(cap, dtype=torch.int32, device=counts.device)
    owner = torch.searchsorted(ends, pos, right=True, out_int32=True)
    slot_valid = pos < total
    owner = torch.where(slot_valid, owner, torch.zeros_like(owner))
    return owner, slot_valid, offsets, total


def expand_draws(draws: DrawList, t_cap: int):
    """Draw list -> per-triangle (inst_id, scene_tri, valid, total)."""
    counts = torch.where(draws.valid, draws.tri_count, torch.zeros_like(draws.tri_count))
    pair_inst, pair_valid, offsets, total = ragged_owner(counts, t_cap)
    pos = torch.arange(t_cap, dtype=torch.int32, device=counts.device)
    local = pos - offsets[pair_inst]
    scene_tri = draws.first_tri[pair_inst] + local
    scene_tri = torch.where(pair_valid, scene_tri, torch.zeros_like(scene_tri))
    return pair_inst, scene_tri, pair_valid, total


def expand_draw_vertices(draws: DrawList, v_cap: int):
    """Draw list -> (draw, vertex) pairs: (vp_inst, scene_vertex, offsets,
    vp_valid, total)."""
    counts = torch.where(
        draws.valid, draws.vertex_count, torch.zeros_like(draws.vertex_count)
    )
    vp_inst, vp_valid, offsets, total = ragged_owner(counts, v_cap)
    pos = torch.arange(v_cap, dtype=torch.int32, device=counts.device)
    local = pos - offsets[vp_inst]
    scene_vertex = torch.where(
        vp_valid, draws.first_vertex[vp_inst] + local, torch.zeros_like(local)
    )
    return vp_inst, scene_vertex, offsets, vp_valid, total


def skin_vertices(positions, normals, joint_indices, joint_weights, palette8):
    """Joint-palette skinning on packed Similarity joints (reference
    skin_vertices, ops/geometry.py:113). Joint rows clamp into the palette
    as the reference's gather does."""
    w = joint_weights / torch.sum(joint_weights, dim=-1, keepdim=True)
    ji = joint_indices.clamp(0, palette8.shape[0] - 1)
    j = palette8[ji]  # (..., 4, 8)
    p = similarity_apply(j, positions[..., None, :])
    skinned_pos = torch.sum(w[..., None] * p, dim=-2)
    n = quat_rotate(j[..., 4:8], normals[..., None, :])
    skinned_nrm = torch.sum(w[..., None] * n, dim=-2)
    return skinned_pos, skinned_nrm


def _uv_transform(uv, offset, scale, rotation):
    """KHR_texture_transform: offset + rot(rotation) * (scale * uv)."""
    c = torch.cos(rotation)[..., None]
    s = torch.sin(rotation)[..., None]
    su = uv * scale
    x = c[..., 0] * su[..., 0] - s[..., 0] * su[..., 1]
    y = s[..., 0] * su[..., 0] + c[..., 0] * su[..., 1]
    return offset + torch.stack([x, y], dim=-1)


class VertexStage(NamedTuple):
    """View-independent geometry (reference VertexStage, :162)."""

    w1: torch.Tensor  # (V_cap, 4) world-space homogeneous positions
    row3: torch.Tensor  # (T_cap, 3) transformed-vertex rows per corner
    pair_inst: torch.Tensor
    scene_tri: torch.Tensor
    pair_valid: torch.Tensor
    double_sided: torch.Tensor
    num_valid: torch.Tensor
    attrs: TriangleAttrs


def geometry_vertex_stage(
    draws: DrawList,
    indices: torch.Tensor,
    positions: torch.Tensor,
    normals: torch.Tensor,
    uvs: torch.Tensor,
    lm_uvs: Optional[torch.Tensor],
    tri_material: torch.Tensor,
    materials: dict,
    t_cap: int,
    v_cap: Optional[int] = None,
    joint_palette: Optional[torch.Tensor] = None,
    joint_indices: Optional[torch.Tensor] = None,
    joint_weights: Optional[torch.Tensor] = None,
) -> VertexStage:
    """View-independent half of the geometry pass: every (draw, vertex)
    pair is skinned/transformed once, then triangles gather their three
    transformed rows (reference :194)."""
    v_cap = v_cap or t_cap
    dev = positions.device

    vp_inst, scene_v, voffsets, vp_valid, vtotal = expand_draw_vertices(draws, v_cap)
    pos = positions[scene_v]
    nrm = normals[scene_v]
    uv = uvs[scene_v]
    lm = lm_uvs[scene_v] if lm_uvs is not None else torch.zeros_like(uv)

    if joint_palette is not None:
        ji = joint_indices[scene_v] + draws.joints_offset[vp_inst][:, None]
        jw = joint_weights[scene_v]
        pos, nrm = skin_vertices(pos, nrm, ji, jw, joint_palette)

    sim8 = draws.sim8[vp_inst]
    world_v = similarity_apply(sim8, pos)
    nrm_v = quat_rotate(sim8[:, 4:8], nrm)

    dmat = draws.material[vp_inst]
    uv_v = _uv_transform(
        uv,
        materials["uv_offset"][dmat],
        materials["uv_scale"][dmat],
        materials["uv_rotation"][dmat],
    )
    w1 = torch.cat([world_v, torch.ones_like(world_v[..., :1])], dim=-1)

    pair_inst, scene_tri, pair_valid, total = expand_draws(draws, t_cap)
    corner = torch.arange(3, dtype=torch.int32, device=dev)
    idx3 = indices[scene_tri[:, None] * 3 + corner[None, :]].to(torch.int32)
    row3 = voffsets[pair_inst][:, None] + (
        idx3 - draws.first_vertex[pair_inst][:, None]
    )
    row_ok = torch.all((row3 >= 0) & (row3 < vtotal), dim=1)
    row3 = row3.clamp(0, v_cap - 1)
    pair_valid = pair_valid & row_ok

    mat = tri_material[scene_tri]
    double_sided = (materials["flags"][mat] & 2) != 0

    attrs = pack_attrs(
        TriangleAttrs(
            world_pos=world_v[row3],
            normal=nrm_v[row3],
            uv=uv_v[row3],
            lm_uv=lm[row3],
            material=mat,
            lightmapped=draws.lightmapped[pair_inst],
        )
    )
    return VertexStage(
        w1=w1,
        row3=row3,
        pair_inst=pair_inst,
        scene_tri=scene_tri.to(torch.int32),
        pair_valid=pair_valid,
        double_sided=double_sided,
        num_valid=total.to(torch.int32),
        attrs=attrs,
    )


def clip_transform(w1: torch.Tensor, view_proj: torch.Tensor) -> torch.Tensor:
    """(..., 4) rows times view_proj^T as explicit multiply-adds in the fixed
    order (x*m0 + y*m1) + (z*m2 + w*m3) per output column -- the order
    XLA's CPU dot uses for these shapes (the reference's matmuls and
    einsums of rows by a 4x4), so the port's clip coordinates (and with
    them the setup rows) equal the reference's bit for bit. The products
    and sums are separate ops: no FMA contraction, no TF32."""
    m = view_proj.to(w1.dtype)
    cols = [
        (w1[..., 0] * m[j, 0] + w1[..., 1] * m[j, 1])
        + (w1[..., 2] * m[j, 2] + w1[..., 3] * m[j, 3])
        for j in range(4)
    ]
    return torch.stack(cols, dim=-1)


def geometry_view_setup(
    stage: VertexStage,
    view_proj: torch.Tensor,
    width: int,
    height: int,
    flip_viewport: bool = False,
) -> TriangleSetup:
    """Per-view half: clip transform + homogeneous edge setup."""
    clip_v = clip_transform(stage.w1, view_proj)
    clip = clip_v[stage.row3]  # (T, 3, 4)
    setup, valid, bbox = _setup_from_clip(
        clip, stage.pair_valid, stage.double_sided, width, height,
        flip_viewport, vertex_ids=stage.row3,
    )
    return TriangleSetup(
        setup=setup,
        tri_id=stage.scene_tri,
        inst_id=stage.pair_inst,
        bbox=bbox,
        valid=valid,
        num_valid=stage.num_valid,
    )


def geometry_pass(
    draws: DrawList,
    indices: torch.Tensor,
    positions: torch.Tensor,
    normals: torch.Tensor,
    uvs: torch.Tensor,
    lm_uvs: Optional[torch.Tensor],
    tri_material: torch.Tensor,
    materials: dict,
    view_proj: torch.Tensor,  # (4, 4)
    width: int,
    height: int,
    t_cap: int,
    v_cap: Optional[int] = None,
    flip_viewport: bool = False,
    joint_palette: Optional[torch.Tensor] = None,
    joint_indices: Optional[torch.Tensor] = None,
    joint_weights: Optional[torch.Tensor] = None,
):
    """Full geometry stage of one view -> (TriangleSetup, TriangleAttrs):
    geometry_vertex_stage + geometry_view_setup (reference :319, without its
    double_sided_from_material, which no caller sets). Multi-view callers
    call the two halves and share the VertexStage across views, as
    render/frame.py does."""
    stage = geometry_vertex_stage(
        draws, indices, positions, normals, uvs, lm_uvs, tri_material, materials, t_cap,
        v_cap=v_cap, joint_palette=joint_palette, joint_indices=joint_indices,
        joint_weights=joint_weights,
    )
    tri = geometry_view_setup(stage, view_proj, width, height, flip_viewport=flip_viewport)
    return tri, stage.attrs


def pack_attrs(attrs: TriangleAttrs) -> TriangleAttrs:
    """Fill TriangleAttrs.packed (reference pack_attrs, :367)."""
    t = attrs.material.shape[0]
    packed = torch.cat(
        [
            attrs.world_pos.reshape(t, 9),
            attrs.normal.reshape(t, 9),
            attrs.uv.reshape(t, 6),
            attrs.lm_uv.reshape(t, 6),
            attrs.material.to(torch.int32).view(torch.float32).reshape(t, 1),
            attrs.lightmapped.to(torch.float32).reshape(t, 1),
        ],
        dim=-1,
    )
    return attrs._replace(packed=packed)


def _setup_from_clip(clip, pair_valid, double_sided, width, height,
                     flip_viewport, vertex_ids=None):
    """Homogeneous triangle setup from clip coords (T, 3, 4) -> (setup,
    valid, bbox); reference _setup_from_clip (:386). With vertex_ids, each
    edge's products are formed with its two vertices in canonical
    (id-sorted) order times an orientation sign, so triangles sharing an
    edge get exactly negated edge functions: watertight without snapping."""
    xc, yc, wc = clip[..., 0], clip[..., 1], clip[..., 3]
    zc = clip[..., 2]
    if flip_viewport:
        yc = -yc
    xv = (xc + wc) * (width * 0.5)
    yv = (wc - yc) * (height * 0.5)

    def edge_coeffs(j, k):
        if vertex_ids is None:
            yj, wj, xj = yv[:, j], wc[:, j], xv[:, j]
            yk, wk, xk = yv[:, k], wc[:, k], xv[:, k]
            a = yj * wk - yk * wj
            b = wj * xk - wk * xj
            c = xj * yk - xk * yj
            return a, b, c
        swap = vertex_ids[:, j] > vertex_ids[:, k]
        sign = torch.where(swap, -1.0, 1.0)

        def pick(arr):
            return (
                torch.where(swap, arr[:, k], arr[:, j]),
                torch.where(swap, arr[:, j], arr[:, k]),
            )

        yj, yk = pick(yv)
        wj, wk = pick(wc)
        xj, xk = pick(xv)
        a = (yj * wk - yk * wj) * sign
        b = (wj * xk - wk * xj) * sign
        c = (xj * yk - xk * yj) * sign
        return a, b, c

    a0, b0, c0 = edge_coeffs(1, 2)
    a1, b1, c1 = edge_coeffs(2, 0)
    a2, b2, c2 = edge_coeffs(0, 1)

    m00, m01, m02 = xv[:, 0], yv[:, 0], wc[:, 0]
    det = m00 * a0 + m01 * b0 + m02 * c0

    front_facing = det < 0.0
    keep = front_facing | double_sided
    flip = torch.where(front_facing, -1.0, 1.0)
    valid = pair_valid & keep & (det != 0.0)

    edge = torch.stack([a0, b0, c0, a1, b1, c1, a2, b2, c2], dim=-1) * flip[:, None]
    flags = torch.where(front_facing, 0.0, FLAG_BACKFACING)
    setup = torch.cat([edge, zc, wc, flags[:, None]], dim=-1).to(torch.float32)

    eps = 1e-6
    w_ok = wc > eps
    inv_w = torch.where(w_ok, 1.0 / torch.clamp_min(wc, eps), 0.0)
    px = xv * inv_w
    py = yv * inv_w
    big = 1e9
    x0 = torch.where(w_ok, px, big).amin(dim=1)
    x1 = torch.where(w_ok, px, -big).amax(dim=1)
    y0 = torch.where(w_ok, py, big).amin(dim=1)
    y1 = torch.where(w_ok, py, -big).amax(dim=1)
    any_behind = ~torch.all(w_ok, dim=1)
    all_behind = ~torch.any(w_ok, dim=1)
    x0 = torch.where(any_behind, 0.0, x0)
    y0 = torch.where(any_behind, 0.0, y0)
    x1 = torch.where(any_behind, float(width - 1), x1)
    y1 = torch.where(any_behind, float(height - 1), y1)
    valid = valid & ~all_behind

    offscreen = (x1 < 0) | (y1 < 0) | (x0 > width - 1) | (y0 > height - 1)
    valid = valid & ~offscreen

    bx0 = torch.floor(x0 - 0.5).clamp(0, width - 1).to(torch.int32)
    by0 = torch.floor(y0 - 0.5).clamp(0, height - 1).to(torch.int32)
    bx1 = torch.ceil(x1 + 0.5).clamp(0, width - 1).to(torch.int32)
    by1 = torch.ceil(y1 + 0.5).clamp(0, height - 1).to(torch.int32)
    bbox = torch.stack([bx0, by0, bx1, by1], dim=-1)
    return setup, valid, bbox


def make_draw_list(sim8, first_tri, tri_count, first_vertex=None,
                   vertex_count=None, joints_offset=None, material=None,
                   lightmapped=None, valid=None, device="cuda") -> DrawList:
    """Convenience constructor with defaults for optional fields."""

    def i32(x, n):
        if x is None:
            return torch.zeros(n, dtype=torch.int32, device=device)
        return torch.as_tensor(x, device=device).to(torch.int32)

    sim8 = torch.as_tensor(sim8, device=device).to(torch.float32)
    n = sim8.shape[0]
    return DrawList(
        sim8=sim8,
        first_tri=i32(first_tri, n),
        tri_count=i32(tri_count, n),
        first_vertex=i32(first_vertex, n),
        vertex_count=i32(vertex_count, n),
        joints_offset=i32(joints_offset, n),
        material=i32(material, n),
        lightmapped=torch.zeros(n, dtype=torch.bool, device=device)
        if lightmapped is None
        else torch.as_tensor(lightmapped, device=device).to(torch.bool),
        valid=torch.ones(n, dtype=torch.bool, device=device)
        if valid is None
        else torch.as_tensor(valid, device=device).to(torch.bool),
    )

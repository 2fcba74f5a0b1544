"""Host-side per-frame draw-list building -> a torch FrameState.

Port of ``superconductor_tpu/render/draws.py`` ``build_frame_state`` (:311)
and its helpers, on the reference's numpy path (the optional native
``framestate.cpp`` path gives the same draws). Culling is the port's copy
of the reference's host module (``render/culling.py``); only the final
arrays become torch tensors on ``device``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import math3d
from ..ops.geometry import DrawList
from ..scene.scene import Model, Scene
from . import culling
from .camera import Uniforms
from .frame import FrameState


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length() if n > 1 else 1


def pack_lines(segments, color_ids, cap: Optional[int] = None) -> dict:
    """Line segments padded to a pow2 cap: numpy {pos (L, 2, 3), color (L,),
    valid (L,)} (reference render/draws.py:98)."""
    n = len(segments)
    cap = cap or max(1, _next_pow2(n))
    pos = np.zeros((cap, 2, 3), np.float32)
    col = np.zeros(cap, np.int32)
    valid = np.zeros(cap, bool)
    if n:
        pos[:n] = np.asarray(segments, np.float32)
        col[:n] = np.asarray(color_ids, np.int32)
        valid[:n] = True
    return {"pos": pos, "color": col, "valid": valid}


def pack_particles(particles: Optional[List[dict]] = None, cap: Optional[int] = None) -> dict:
    """Particle dicts padded to a pow2 cap, as a numpy SoA of the
    ParticleInstance fields (reference render/draws.py:112)."""
    particles = particles or []
    n = len(particles)
    cap = cap or max(1, _next_pow2(n))

    def field(name, dim, default=0.0):
        out = np.full((cap, dim) if dim > 1 else (cap,), default, np.float32)
        for i, p in enumerate(particles):
            out[i] = p.get(name, default)
        return out

    return {
        "center": field("center", 3),
        "scale": field("scale", 2, 1.0),
        "colour": field("colour", 3, 1.0),
        "uv_offset": field("uv_offset", 2, 0.0),
        "uv_scale": field("uv_scale", 2, 1.0),
        "emissive_colour": field("emissive_colour", 3, 0.0),
        "use_emissive_lut": np.array(
            [p.get("use_emissive_lut", 0) for p in particles] + [0] * (cap - n), np.int32
        ),
        "lut_y": field("lut_y", 1, 0.0),
        "valid": np.array([True] * n + [False] * (cap - n), bool),
    }


def _soa_to_torch(soa: dict, device) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in soa.items()}


def _model_frame_arrays(model: Model) -> dict:
    """Per-model SoA of primitive metadata, cached on the Model under the
    reference's key (so Model.invalidate_frame_cache() drops it too). LOD
    tables pad to the model's deepest chain by repeating the last level;
    coverage thresholds pad with -inf so padding never selects."""
    cache = model.__dict__.get("_frame_arrays")
    if cache is not None:
        return cache
    prims = model.primitives
    n = len(prims)
    lmax = max((len(p.lods) for p in prims), default=1)

    def lod_col(get, dtype):
        out = np.zeros((n, lmax), dtype)
        for i, p in enumerate(prims):
            vals = [get(l) for l in p.lods]
            vals += [vals[-1]] * (lmax - len(vals))
            out[i] = vals
        return out

    cov = np.full((n, lmax), -np.inf, np.float32)
    for i, p in enumerate(prims):
        if p.lod_coverages:
            c = np.asarray(p.lod_coverages, np.float32)[:lmax]
            cov[i, : len(c)] = c

    def _bb(v):
        return np.zeros(3, np.float32) if v is None else np.asarray(v, np.float32)

    def stack3(vals):
        return np.stack(vals) if n else np.zeros((0, 3), np.float32)

    cache = {
        "prim8": np.stack([p.transform.to_array() for p in prims])
        if n
        else np.zeros((0, 8), np.float32),
        "radius": np.array([p.bounding_sphere_radius for p in prims], np.float32),
        "material": np.array([p.material for p in prims], np.int32),
        "animated": np.array([p.animated for p in prims], bool),
        "n_lods": np.array([max(1, len(p.lods)) for p in prims], np.int32),
        "bbox_min": stack3([_bb(p.bbox_min) for p in prims]),
        "bbox_max": stack3([_bb(p.bbox_max) for p in prims]),
        "lod_cov": cov,
        "lod_first_tri": lod_col(lambda l: l.first_index // 3, np.int32),
        "lod_tri_count": lod_col(lambda l: l.index_count // 3, np.int32),
        "lod_first_vertex": lod_col(lambda l: l.first_vertex, np.int32),
        "lod_vertex_count": lod_col(lambda l: l.vertex_count, np.int32),
        "lod_lightmapped": lod_col(lambda l: l.lightmapped, bool),
    }
    model.__dict__["_frame_arrays"] = cache
    return cache


_LOD_KEYS = (
    "lod_cov", "lod_first_tri", "lod_tri_count", "lod_first_vertex",
    "lod_vertex_count", "lod_lightmapped",
)
_FLAT_KEYS = ("prim8", "radius", "material", "animated", "n_lods",
              "bbox_min", "bbox_max")


def _big_tables(mas: list) -> dict:
    """Concatenated per-model SoA tables for a frame's unique model list
    (LOD tables padded to the frame's deepest chain)."""
    lmax = max(ma["lod_cov"].shape[1] for ma in mas)
    tables = {k: np.concatenate([ma[k] for ma in mas]) for k in _FLAT_KEYS}
    for k in _LOD_KEYS:
        tables[k] = np.concatenate(
            [np.pad(ma[k], ((0, 0), (0, lmax - ma[k].shape[1])), mode="edge")
             for ma in mas]
        )
    counts = np.array([ma["prim8"].shape[0] for ma in mas], np.int32)
    tables["prim_counts"] = counts
    tables["prim_base"] = np.concatenate([[0], counts.cumsum()[:-1]]).astype(np.int32)
    return tables


def _register_palettes(instances, joint_palettes, inst_visible):
    """Concatenate joint palettes of visible animated instances in instance
    order -> (palette list, per-instance offsets)."""
    palettes: List[np.ndarray] = []
    palette_offset = 0
    inst_pal_offset = np.zeros(len(instances), np.int32)
    if joint_palettes is not None:
        for inst_index, (model, _s) in enumerate(instances):
            if not (inst_visible[inst_index] and model.animated):
                continue
            pal = joint_palettes.get(inst_index)
            if pal is not None and len(pal):
                inst_pal_offset[inst_index] = palette_offset
                palettes.append(np.asarray(pal, np.float32))
                palette_offset += len(pal)
    return palettes, inst_pal_offset


def _no_draws() -> dict:
    """A compact draw dict with no rows."""
    d = {k: np.zeros(0, np.int32) for k in (
        "first_tri", "tri_count", "first_vertex", "vertex_count", "material", "inst")}
    d["sim8"] = np.zeros((0, 8), np.float32)
    d["lightmapped"] = np.zeros(0, bool)
    return d


def _pack_compact(c: dict, inst_pal_offset, draw_cap, device) -> DrawList:
    """Pad a compact draw dict (n visible rows) to a pow2-cap DrawList of
    tensors on ``device``; joints_offset comes from the row's instance."""
    n = len(c["first_tri"])
    cap = draw_cap or max(1, _next_pow2(n))
    sim8 = np.zeros((cap, 8), np.float32)
    sim8[:, 7] = 1.0
    sim8[:n] = c["sim8"]

    def col(vals, dtype=np.int32):
        out = np.zeros(cap, dtype)
        out[:n] = vals
        return torch.from_numpy(out).to(device)

    return DrawList(
        sim8=torch.from_numpy(sim8).to(device),
        first_tri=col(c["first_tri"]),
        tri_count=col(c["tri_count"]),
        first_vertex=col(c["first_vertex"]),
        vertex_count=col(c["vertex_count"]),
        joints_offset=col(inst_pal_offset[c["inst"]]),
        material=col(c["material"]),
        lightmapped=col(c["lightmapped"], bool),
        valid=col(np.ones(n, bool), bool),
    )


def uniforms_to_torch(uniforms: Uniforms, device) -> dict:
    """Uniforms.as_device_dict() as f32 tensors (leading view axis kept)."""
    return {
        k: torch.tensor(np.asarray(v, np.float32), device=device)
        for k, v in uniforms.as_device_dict().items()
    }


def build_frame_state(
    scene: Scene,
    instances: Sequence[Tuple[Model, "math3d.Similarity"]],
    uniforms: Uniforms,
    joint_palettes: Optional[dict] = None,
    cull_params: Optional[list] = None,
    screen_height: int = 1080,
    draw_cap: Optional[int] = None,
    lines: Optional[dict] = None,
    particles: Optional[dict] = None,
    sat: Optional[tuple] = None,
    device="cuda",
    counts_out: Optional[dict] = None,
) -> FrameState:
    """Walk instances, cull, select LODs, emit a torch FrameState (the
    reference's numpy path, render/draws.py:398-510). `lines` and
    `particles` are pack_lines / pack_particles dicts; missing ones are
    empty packs, as in the reference. `counts_out`, when given, receives
    the host-side triangle and vertex counts of the visible draws
    ("tris_static", "verts_static", "tris_animated", "verts_animated"),
    so a caller can size capacities without reading the tensors back."""
    uniq: dict = {}
    inst_uid = np.empty(len(instances), np.int32)
    for inst_index, (model, _s) in enumerate(instances):
        ent = uniq.get(id(model))
        if ent is None:
            ent = (len(uniq), _model_frame_arrays(model))
            uniq[id(model)] = ent
        inst_uid[inst_index] = ent[0]
    mas = [ma for (_uid, ma) in sorted(uniq.values(), key=lambda e: e[0])]

    if mas:
        tables = _big_tables(mas)
        prim_counts, prim_base = tables["prim_counts"], tables["prim_base"]
    else:
        prim_counts = prim_base = np.zeros(0, np.int32)
    counts = prim_counts[inst_uid] if len(instances) else np.zeros(0, np.int32)
    n_cand = int(counts.sum())

    static_c = anim_c = _no_draws()
    palettes: List[np.ndarray] = []
    inst_pal_offset = np.zeros(len(instances), np.int32)
    if n_cand:
        ends = counts.cumsum()
        cand_inst = np.repeat(np.arange(len(instances), dtype=np.int32), counts)
        prim_row = (
            np.arange(n_cand, dtype=np.int32)
            - np.repeat(ends - counts, counts)
            + np.repeat(prim_base[inst_uid], counts)
        )
        inst8 = np.stack([s.to_array() for (_m, s) in instances]).astype(np.float32)
        cand8 = math3d.similarity_compose8(
            inst8[cand_inst], tables["prim8"][prim_row]
        ).astype(np.float32)

        def cat(key):
            return tables[key][prim_row]

        radii = cand8[:, 3] * cat("radius")
        centers = cand8[:, 0:3]

        visible_mask = np.ones(n_cand, bool)
        if cull_params:
            vis = np.zeros(n_cand, bool)
            for cp in cull_params:
                vis |= culling.test_bounding_spheres(centers, radii, cp)
            visible_mask &= vis
        if sat is not None:
            view_m, frustum = sat
            idxs = np.where(visible_mask)[0]
            if len(idxs):
                keep = culling.test_obbs_sat_exact(
                    cat("bbox_min")[idxs], cat("bbox_max")[idxs], cand8[idxs],
                    view_m, frustum,
                )
                visible_mask[idxs] &= keep

        n_lods = cat("n_lods")
        lod = np.zeros(n_cand, np.int32)
        if (n_lods > 1).any():
            eye = np.asarray(uniforms.eye[0], np.float32)
            d = np.linalg.norm(centers - eye[None], axis=1)
            vr = radii / np.where(d <= 0.0, 1.0, d)
            aspect = 1920 / screen_height
            y = np.tan(np.radians(59.0) / 2.0)
            cov = np.where(d <= 0.0, np.inf, np.pi * vr * vr / (y * y * aspect)).astype(
                np.float32
            )
            lod = (cat("lod_cov") > cov[:, None]).sum(1).astype(np.int32)
            lod = np.minimum(lod, n_lods - 1)

        inst_visible = np.zeros(len(instances), bool)
        inst_visible[np.unique(cand_inst[visible_mask])] = True
        palettes, inst_pal_offset = _register_palettes(
            instances, joint_palettes, inst_visible
        )

        animated = cat("animated")
        material = cat("material")
        lt_first, lt_count = cat("lod_first_tri"), cat("lod_tri_count")
        lv_first, lv_count = cat("lod_first_vertex"), cat("lod_vertex_count")
        lt_lm = cat("lod_lightmapped")

        def compact(select):
            k = np.where(visible_mask & select)[0]
            lk = lod[k]
            return {
                "sim8": cand8[k],
                "first_tri": lt_first[k, lk],
                "tri_count": lt_count[k, lk],
                "first_vertex": lv_first[k, lk],
                "vertex_count": lv_count[k, lk],
                "material": material[k],
                "lightmapped": lt_lm[k, lk],
                "inst": cand_inst[k],
            }

        static_c, anim_c = compact(~animated), compact(animated)

    if counts_out is not None:
        for kind, c in (("static", static_c), ("animated", anim_c)):
            counts_out["tris_" + kind] = int(np.asarray(c["tri_count"], np.int64).sum())
            counts_out["verts_" + kind] = int(np.asarray(c["vertex_count"], np.int64).sum())

    palette = np.concatenate(palettes, axis=0) if palettes else np.zeros((1, 8), np.float32)
    if palette.shape[0] < _next_pow2(palette.shape[0]):
        pad = _next_pow2(palette.shape[0]) - palette.shape[0]
        palette = np.concatenate([palette, np.zeros((pad, 8), np.float32)])

    return FrameState(
        uniforms=uniforms_to_torch(uniforms, device),
        draws_static=_pack_compact(static_c, inst_pal_offset, draw_cap, device),
        draws_animated=_pack_compact(anim_c, inst_pal_offset, draw_cap, device),
        joint_palette=torch.from_numpy(palette.astype(np.float32)).to(device),
        lines=_soa_to_torch(lines if lines is not None else pack_lines([], []), device),
        particles=_soa_to_torch(
            particles if particles is not None else pack_particles(), device
        ),
    )

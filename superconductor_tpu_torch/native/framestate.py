"""ctypes binding for the native per-frame draw-list build (the port's
copy of ``superconductor_tpu/native/framestate.py``).

`build_draws_native` mirrors render/draws.py's vectorized numpy candidate
walk (compose -> sphere-cull -> LOD -> pack) in C++ (src/framestate.cpp, a
byte-for-byte copy of the reference's, built into the port's own library).
The port's library is built or raises (native/__init__.py), so
`available()` raises where the reference would report False.

Marshalling cost matters here (the call runs every frame): pointers for the
cached big tables are computed once and stashed on the tables dict, and the
compact output buffers live in a grow-only scratch pool whose pointers are
likewise cached. `build_draws_native`'s returned arrays alias that scratch —
callers must copy them out (render/draws.py::_pack_compact does) before the
next frame's call.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import load_native

_TABLE_KEYS = (
    "prim_base", "prim_counts", "prim8", "radius", "material",
    "animated_u8", "n_lods", "lod_cov", "lod_first_tri", "lod_tri_count",
    "lod_first_vertex", "lod_vertex_count", "lod_lightmapped_u8",
)

_OUT_KEYS = (
    "sim8", "first_tri", "tri_count", "first_vertex", "vertex_count",
    "material", "lightmapped", "inst",
)


def _p(a: np.ndarray) -> int:
    return a.ctypes.data


_configured = False


def available() -> bool:
    """True once sc_build_draws has its argtypes; raises when the library
    cannot be built or loaded."""
    global _configured
    lib = load_native()
    ok = hasattr(lib, "sc_build_draws")
    if ok and not _configured:
        # every pointer crosses as void*; ints/doubles explicit
        f = lib.sc_build_draws
        f.restype = ctypes.c_int32
        f.argtypes = (
            [ctypes.c_int32] + [ctypes.c_void_p] * 2          # n_inst, inst8, uid
            + [ctypes.c_void_p] * 2                           # prim_base/counts
            + [ctypes.c_int32] + [ctypes.c_void_p] * 11       # lmax + tables
            + [ctypes.c_int32] + [ctypes.c_void_p] * 2        # culling
            + [ctypes.c_int32, ctypes.c_void_p, ctypes.c_double]  # lod
            + [ctypes.c_void_p] * 8                           # static out
            + [ctypes.c_void_p] * 8                           # animated out
            + [ctypes.c_void_p] * 2                           # inst_visible, counts
        )
        _configured = True
    return ok


class _Scratch:
    """Grow-only output buffers + cached pointers, reused across frames."""

    def __init__(self):
        self.cap = 0
        self.counts = np.zeros(2, np.int32)
        self.counts_ptr = _p(self.counts)

    def ensure(self, n_cand: int):
        if n_cand <= self.cap:
            return
        cap = max(64, 1 << (n_cand - 1).bit_length())
        self.s = self._alloc(cap)
        self.a = self._alloc(cap)
        self.s_ptrs = [_p(self.s[k]) for k in _OUT_KEYS]
        self.a_ptrs = [_p(self.a[k]) for k in _OUT_KEYS]
        self.cap = cap

    @staticmethod
    def _alloc(cap):
        return {
            "sim8": np.empty((cap, 8), np.float32),
            "first_tri": np.empty(cap, np.int32),
            "tri_count": np.empty(cap, np.int32),
            "first_vertex": np.empty(cap, np.int32),
            "vertex_count": np.empty(cap, np.int32),
            "material": np.empty(cap, np.int32),
            "lightmapped": np.empty(cap, np.uint8),
            "inst": np.empty(cap, np.int32),
        }


_scratch = _Scratch()


def build_draws_native(
    inst8: np.ndarray,  # (n_inst, 8) f32, C-contiguous
    inst_uid: np.ndarray,  # (n_inst,) i32
    tables: dict,  # _big_tables output (render/draws.py)
    cull_planes,  # list of (P, 4) f32 plane arrays, or None
    do_lod: bool,
    eye3: np.ndarray,  # (3,) f32
    denom: float,
    copy: bool = True,
):
    """Run the candidate walk natively.

    Returns (static, animated, inst_visible): dicts of compact arrays
    (n rows). With copy=True (default) the arrays are owned by the caller.
    copy=False returns views ALIASING the shared grow-only scratch pool —
    overwritten by the next call; only for hot-path callers that consume
    the rows before building the next frame (render/draws._pack_compact
    repacks them immediately).
    """
    if not available():  # also configures argtypes — without them ctypes
        raise RuntimeError(  # would truncate 64-bit pointers to C int
            "scnative sc_build_draws unavailable"
        )
    lib = load_native()
    n_inst = len(inst_uid)
    n_cand = int(tables["prim_counts"][inst_uid].sum()) if n_inst else 0
    _scratch.ensure(n_cand)

    ptrs = tables.get("_ptrs")
    if ptrs is None:
        ptrs = tables["_ptrs"] = [_p(tables[k]) for k in _TABLE_KEYS]

    if cull_planes:
        planes = np.ascontiguousarray(
            np.concatenate(cull_planes, axis=0), np.float32
        )
        set_off = np.concatenate(
            [[0], np.cumsum([len(p) for p in cull_planes])]
        ).astype(np.int32)
        n_sets = len(cull_planes)
    else:
        planes = np.zeros((0, 4), np.float32)
        set_off = np.zeros(1, np.int32)
        n_sets = 0

    inst_visible = np.zeros(n_inst, np.uint8)
    eye3 = np.ascontiguousarray(eye3, np.float32)

    lib.sc_build_draws(
        n_inst, _p(inst8), _p(inst_uid),
        ptrs[0], ptrs[1],
        tables["lod_cov"].shape[1],
        *ptrs[2:13],
        n_sets, _p(set_off), _p(planes),
        1 if do_lod else 0, _p(eye3), denom,
        *_scratch.s_ptrs,
        *_scratch.a_ptrs,
        _p(inst_visible), _scratch.counts_ptr,
    )
    ns, na = int(_scratch.counts[0]), int(_scratch.counts[1])
    static = {k: _scratch.s[k][:ns] for k in _OUT_KEYS}
    anim = {k: _scratch.a[k][:na] for k in _OUT_KEYS}
    if copy:
        static = {k: v.copy() for k, v in static.items()}
        anim = {k: v.copy() for k, v in anim.items()}
    return static, anim, inst_visible.astype(bool)

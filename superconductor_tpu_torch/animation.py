"""Keyframe animation: channels, samplers, and the joint hierarchy update.

Behavioral parity with the reference engine's gltf-helpers/src/animation.rs:
  * ``Channel.sample(t)`` returns None outside the keyframe range, otherwise
    binary-searches the input times and interpolates Step / Linear /
    CubicSpline (animation.rs:204-265, 392-415).
  * ``Animation.animate`` overwrites sampled local TRS components
    (animation.rs:280-302).
  * ``AnimationJoints.update`` walks roots then parent-first children
    (animation.rs:154-166); ``iter`` yields global * inverse_bind per joint
    (animation.rs:138-152).

The host keeps per-node Similarity SoA numpy arrays so the whole hierarchy
update is vectorized where possible; the resulting joint palette is uploaded
as one (J, 8) array for the device skinning kernel (the reference is limited
to 2048 joints per 64 KiB UBO, shared-structs/src/lib.rs:319-355 — we keep a
single global HBM palette instead).

The port's copy of ``superconductor_tpu/animation.py``. Sampling and the
hierarchy walk run natively (``sc_anim_sample`` / ``sc_joint_update`` in
``native/src/framestate.cpp``, a byte-for-byte copy of the reference's) as
the reference's do, so palettes round as the JAX package's default path
rounds them. The port's library is built or raises (native/__init__.py):
a library that lacks a function raises too, where the reference falls back.
Setting ``_anim_sample_fn`` / ``_joint_update_fn`` to False is the explicit
numpy path (the tests' switch, as in the reference's).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .math3d import Similarity, quat_mul, quat_normalize, quat_rotate
from .nodes import DepthFirstNodes

_joint_update_fn = None  # None = untried, False = the numpy path
_anim_sample_fn = None


def _load_fn(name: str, argtypes):
    """Resolve a libscnative function with argtypes set (shared lazy-load
    for the animation fast paths). Raises when the library cannot be built
    or lacks the function."""
    from .native import load_native

    fn = getattr(load_native(), name)
    fn.restype = None
    fn.argtypes = argtypes
    return fn


def _get_anim_sample_fn():
    global _anim_sample_fn
    if _anim_sample_fn is None:
        import ctypes

        _anim_sample_fn = _load_fn(
            "sc_anim_sample",
            [ctypes.c_int32] + [ctypes.c_void_p] * 3
            + [ctypes.c_float] + [ctypes.c_void_p] * 3,
        )
    return _anim_sample_fn


def _get_joint_update_fn():
    global _joint_update_fn
    if _joint_update_fn is None:
        import ctypes

        _joint_update_fn = _load_fn(
            "sc_joint_update",
            [ctypes.c_int32] * 2
            + [ctypes.c_int32, ctypes.c_void_p]
            + [ctypes.c_int32] + [ctypes.c_void_p] * 2
            + [ctypes.c_void_p] * 6,
        )
    return _joint_update_fn


def _native_animate(anim, joints: "AnimationJoints", time: float) -> bool:
    """Channel sampling + local writes in C++ (sc_anim_sample) — mirrors
    Channel.sample exactly (binary search, STEP/LINEAR/slerp/CUBIC,
    out-of-range keeps the rest pose). ~50 us per channel in Python, ~50 ns
    native."""
    fn = _get_anim_sample_fn()
    if fn is False:
        return False
    for a in (joints.local_translation, joints.local_scale,
              joints.local_rotation):
        if a.dtype != np.float32 or not a.flags.c_contiguous:
            return False
    packed = anim._packed_channels()
    if packed is None:  # malformed channels: Python path raises cleanly
        return False
    meta, ins, outs, max_node = packed
    if max_node >= len(joints.local_scale):
        return False  # out-of-range node: Python raises IndexError
    fn(
        len(meta), meta.ctypes.data, ins.ctypes.data, outs.ctypes.data,
        float(time),
        joints.local_translation.ctypes.data,
        joints.local_scale.ctypes.data,
        joints.local_rotation.ctypes.data,
    )
    return True


def _native_update(aj: "AnimationJoints", depth_first: DepthFirstNodes) -> bool:
    """Run the hierarchy walk in C++ (sc_joint_update) when available —
    the Python link loop costs ~40 us/link in numpy overhead, which
    dominates per-frame animation at scale (64 instances x 64 joints was
    ~170 ms/frame in pure Python)."""
    if _get_joint_update_fn() is False:
        return False
    links = depth_first.__dict__.get("_link_arrays")
    if links is None:
        links = (
            np.asarray(depth_first.roots, np.int32),
            np.array([l.parent for l in depth_first.children], np.int32),
            np.array([l.index for l in depth_first.children], np.int32),
        )
        depth_first.__dict__["_link_arrays"] = links
    roots, parents, childs = links
    return _call_joint_update(
        aj.local_translation, aj.local_scale, aj.local_rotation,
        aj.global_translation, aj.global_scale, aj.global_rotation,
        roots, parents, childs, 1, len(aj.local_scale),
    )


def _call_joint_update(lt, ls, lr, gt, gs, gr, roots, parents, childs,
                       n_inst, n_nodes) -> bool:
    fn = _get_joint_update_fn()
    if fn is False:
        return False
    for a in (lt, ls, lr, gt, gs, gr):
        if a.dtype != np.float32 or not a.flags.c_contiguous:
            return False
    fn(
        n_inst, n_nodes,
        len(roots), roots.ctypes.data,
        len(parents), parents.ctypes.data, childs.ctypes.data,
        lt.ctypes.data, ls.ctypes.data, lr.ctypes.data,
        gt.ctypes.data, gs.ctypes.data, gr.ctypes.data,
    )
    return True


def joint_palettes_batch(
    local_translation: np.ndarray,  # (I, N, 3) f32
    local_scale: np.ndarray,  # (I, N) f32
    local_rotation: np.ndarray,  # (I, N, 4) f32
    roots: np.ndarray,  # (R,) i32
    link_parent: np.ndarray,  # (L,) i32, parent-before-child order
    link_child: np.ndarray,  # (L,) i32
    joint_node_indices: np.ndarray,  # (J,) node per joint
    inverse_bind8: np.ndarray,  # (J, 8)
) -> Optional[np.ndarray]:
    """(I, J, 8) palettes for I independent instances of one skeleton:
    the batched form of AnimationJoints.joint_palette, hierarchy walk in
    C++ (sc_joint_update with n_inst=I), palette composition vectorized.
    Returns None on the explicit numpy path (_joint_update_fn = False;
    callers then take per-instance AnimationJoints)."""
    if _get_joint_update_fn() is False:
        return None
    I, N = local_scale.shape
    lt = np.ascontiguousarray(local_translation, np.float32)
    ls = np.ascontiguousarray(local_scale, np.float32)
    lr = np.ascontiguousarray(local_rotation, np.float32)
    gt = np.empty_like(lt)
    gs = np.empty_like(ls)
    gr = np.empty_like(lr)
    if not _call_joint_update(
        lt, ls, lr, gt, gs, gr,
        np.ascontiguousarray(roots, np.int32),
        np.ascontiguousarray(link_parent, np.int32),
        np.ascontiguousarray(link_child, np.int32), I, N,
    ):
        return None
    tg = gt[:, joint_node_indices]
    sg = gs[:, joint_node_indices][..., None]
    qg = gr[:, joint_node_indices]
    ti = inverse_bind8[None, :, 0:3]
    si = inverse_bind8[None, :, 3:4]
    qi = inverse_bind8[None, :, 4:8]
    t = tg + sg * quat_rotate(qg, ti)
    s = sg * si
    q = quat_normalize(quat_mul(qg, qi))
    return np.concatenate([t, s, q], axis=-1).astype(np.float32)

STEP = 0
LINEAR = 1
CUBIC_SPLINE = 2

_INTERP_NAMES = {"STEP": STEP, "LINEAR": LINEAR, "CUBICSPLINE": CUBIC_SPLINE}


@dataclass
class Channel:
    """One animated property of one node. outputs shape: (K, D) or (3K, D)."""

    interpolation: int
    inputs: np.ndarray  # (K,) f32, strictly increasing
    outputs: np.ndarray  # (K, D) — or (3K, D) for cubic spline
    node_index: int

    def sample(self, t: float) -> Optional[np.ndarray]:
        inputs = self.inputs
        if t < inputs[0] or t > inputs[-1]:
            return None
        if len(inputs) == 1:  # single key: hold its value (t == inputs[0])
            if self.interpolation == CUBIC_SPLINE:
                return self.outputs[1]
            return self.outputs[0]
        i = int(np.searchsorted(inputs, t, side="right") - 1)
        if i == len(inputs) - 1:
            if inputs[i] == t:
                i -= 1
            else:
                return None
        prev_t = inputs[i]
        next_t = inputs[i + 1]
        delta = next_t - prev_t
        factor = (t - prev_t) / delta

        if self.interpolation == STEP:
            return self.outputs[i]
        if self.interpolation == LINEAR:
            a, b = self.outputs[i], self.outputs[i + 1]
            if a.shape[-1] == 4:  # quaternion: shortest-path nlerp-free slerp
                return _quat_linear(a, b, factor)
            return a + (b - a) * factor
        # Cubic spline: outputs packed [in_tangent, value, out_tangent] * K
        p0 = self.outputs[i * 3 + 1]
        m0 = self.outputs[i * 3 + 2] * delta
        m1 = self.outputs[i * 3 + 3] * delta
        p1 = self.outputs[i * 3 + 4]
        t_ = factor
        t2, t3 = t_ * t_, t_ * t_ * t_
        value = (
            (2 * t3 - 3 * t2 + 1) * p0
            + (t3 - 2 * t2 + t_) * m0
            + (-2 * t3 + 3 * t2) * p1
            + (t3 - t2) * m1
        )
        if value.shape[-1] == 4:
            value = value / np.linalg.norm(value)
        return value


def _quat_linear(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    """glTF linear quaternion interpolation = slerp with sign fix."""
    dot = float(np.dot(a, b))
    if dot < 0.0:
        b = -b
        dot = -dot
    if dot > 0.9995:
        out = a + (b - a) * factor
        return out / np.linalg.norm(out)
    theta = np.arccos(np.clip(dot, -1.0, 1.0))
    s = np.sin(theta)
    return (np.sin((1 - factor) * theta) / s) * a + (np.sin(factor * theta) / s) * b


@dataclass
class Animation:
    translation_channels: List[Channel] = field(default_factory=list)
    rotation_channels: List[Channel] = field(default_factory=list)
    scale_channels: List[Channel] = field(default_factory=list)
    total_time: float = 0.0

    def _packed_channels(self):
        """Concatenated channel arrays + (C, 7) meta for sc_anim_sample,
        built once per Animation (channels are immutable after first use,
        like Model._frame_arrays): [kind, node, interp, K, in_off, out_off,
        D] with float element offsets.

        Returns None when any channel is malformed (bad component count,
        negative node, or an outputs array shorter than the keyframe count
        demands) — the raw-pointer C++ consumer must never see such meta,
        so those animations take the Python path, which raises the same
        clean errors it always did. The meta's max node index is returned
        for the per-call bound check against the joint array length."""
        if "_packed" in self.__dict__:
            return self.__dict__["_packed"]  # may be None (invalid meta)
        metas, ins, outs = [], [], []
        in_off = out_off = 0
        max_node = -1
        valid = True
        for kind, chans in (
            (0, self.translation_channels),
            (1, self.rotation_channels),
            (2, self.scale_channels),
        ):
            expect_d = {0: (3,), 1: (4,), 2: (1, 2, 3, 4)}[kind]
            for ch in chans:
                inp = np.ascontiguousarray(ch.inputs, np.float32)
                out = np.ascontiguousarray(
                    np.atleast_2d(ch.outputs), np.float32
                )
                k = len(inp)
                d = out.shape[1]
                need_rows = 3 * k if ch.interpolation == CUBIC_SPLINE else k
                if (
                    d not in expect_d
                    or ch.node_index < 0
                    or out.shape[0] < need_rows
                    or ch.interpolation not in (STEP, LINEAR, CUBIC_SPLINE)
                ):
                    valid = False
                max_node = max(max_node, int(ch.node_index))
                metas.append([
                    kind, ch.node_index, ch.interpolation, k,
                    in_off, out_off, d,
                ])
                ins.append(inp)
                outs.append(out.reshape(-1))
                in_off += k
                out_off += out.size
        cached = (
            (
                np.ascontiguousarray(metas, np.int32).reshape(-1, 7),
                np.concatenate(ins) if ins else np.zeros(0, np.float32),
                np.concatenate(outs) if outs else np.zeros(0, np.float32),
                max_node,
            )
            if valid
            else None
        )
        self.__dict__["_packed"] = cached
        return cached

    def animate(self, joints: "AnimationJoints", time: float) -> None:
        if _native_animate(self, joints, time):
            return
        for ch in self.translation_channels:
            v = ch.sample(time)
            if v is not None:
                joints.local_translation[ch.node_index] = v
        for ch in self.rotation_channels:
            v = ch.sample(time)
            if v is not None:
                joints.local_rotation[ch.node_index] = v
        for ch in self.scale_channels:
            v = ch.sample(time)
            if v is not None:
                joints.local_scale[ch.node_index] = float(np.max(v))


class AnimationJoints:
    """Per-node local + global Similarity state, stored SoA (numpy)."""

    def __init__(self, local_transforms: List[Similarity]):
        n = len(local_transforms)
        self.local_translation = np.stack(
            [t.translation for t in local_transforms]
        ) if n else np.zeros((0, 3), np.float32)
        self.local_scale = np.array([t.scale for t in local_transforms], np.float32)
        self.local_rotation = np.stack(
            [t.rotation for t in local_transforms]
        ) if n else np.zeros((0, 4), np.float32)
        self.global_translation = self.local_translation.copy()
        self.global_scale = self.local_scale.copy()
        self.global_rotation = self.local_rotation.copy()

    def update(self, depth_first: DepthFirstNodes) -> None:
        if _native_update(self, depth_first):
            return
        for r in depth_first.roots:
            self.global_translation[r] = self.local_translation[r]
            self.global_scale[r] = self.local_scale[r]
            self.global_rotation[r] = self.local_rotation[r]
        for link in depth_first.children:
            p, c = link.parent, link.index
            pr = self.global_rotation[p]
            ps = self.global_scale[p]
            self.global_translation[c] = self.global_translation[p] + ps * quat_rotate(
                pr, self.local_translation[c]
            )
            self.global_scale[c] = ps * self.local_scale[c]
            self.global_rotation[c] = quat_mul(pr, self.local_rotation[c])

    def joint_palette(
        self,
        joint_node_indices: np.ndarray,
        inverse_bind8: np.ndarray,
        depth_first: DepthFirstNodes,
    ) -> np.ndarray:
        """(J, 8) packed [t, s, q] = global[node] * inverse_bind[joint].

        The composition matches Similarity::__mul__: for g = (tg, sg, qg) and
        ib = (ti, si, qi): t = tg + sg*(qg*ti), s = sg*si, q = qg*qi.
        """
        self.update(depth_first)
        tg = self.global_translation[joint_node_indices]
        sg = self.global_scale[joint_node_indices][:, None]
        qg = self.global_rotation[joint_node_indices]
        ti = inverse_bind8[:, 0:3]
        si = inverse_bind8[:, 3:4]
        qi = inverse_bind8[:, 4:8]
        t = tg + sg * quat_rotate(qg, ti)
        s = sg * si
        q = quat_normalize(quat_mul(qg, qi))
        return np.concatenate([t, s, q], axis=-1).astype(np.float32)

    def global_similarity(self, node: int) -> Similarity:
        return Similarity(
            self.global_translation[node],
            float(self.global_scale[node]),
            self.global_rotation[node],
        )

    def set_local(self, node: int, sim: Similarity) -> None:
        self.local_translation[node] = sim.translation
        self.local_scale[node] = sim.scale
        self.local_rotation[node] = sim.rotation


def read_animations(gltf: dict, accessor_reader) -> List[Animation]:
    """Parse glTF animations into Channel lists.

    ``accessor_reader(index) -> np.ndarray`` decodes an accessor. Mirrors
    read_animations (animation.rs:8-103) including dropping unsupported
    paths (weights) and computing total_time as the max input time.
    """
    out: List[Animation] = []
    for anim in gltf.get("animations", ()):
        a = Animation()
        samplers = anim.get("samplers", ())
        for chan in anim.get("channels", ()):
            target = chan.get("target", {})
            node_index = target.get("node")
            path = target.get("path")
            if node_index is None or path not in ("translation", "rotation", "scale"):
                continue
            sampler = samplers[chan["sampler"]]
            interpolation = _INTERP_NAMES.get(sampler.get("interpolation", "LINEAR"))
            if interpolation is None:
                continue
            inputs = np.asarray(accessor_reader(sampler["input"]), np.float32).reshape(-1)
            outputs = np.asarray(accessor_reader(sampler["output"]), np.float32)
            if outputs.ndim == 1:
                outputs = outputs[:, None]
            ch = Channel(interpolation, inputs, outputs, node_index)
            a.total_time = max(a.total_time, float(inputs[-1]))
            if path == "translation":
                a.translation_channels.append(ch)
            elif path == "rotation":
                a.rotation_channels.append(ch)
            else:
                a.scale_channels.append(ch)
        out.append(a)
    return out

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

The port's copy of ``superconductor_tpu/animation.py`` without the native
fast paths (``sc_anim_sample`` / ``sc_joint_update``, in the reference's
framestate.cpp, which the port's library does not build): sampling and the
hierarchy walk always take the numpy code below.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .math3d import Similarity, quat_mul, quat_normalize, quat_rotate
from .nodes import DepthFirstNodes

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

    def animate(self, joints: "AnimationJoints", time: float) -> None:
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

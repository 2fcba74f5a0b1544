"""Smoothed fly-camera rig — the analog of the reference demo's dolly rig
(demo/src/lib.rs:307-397: CameraRig<Position + YawPitch + Smooth>, WASD +
mouse input, update_camera smoothing).

The rig holds a TARGET position/yaw/pitch driven by movement commands, and
exponentially smooths the RENDERED pose toward it each update — dolly's
``Smooth`` stage. Scriptable: ``apply_keys`` consumes WASD/QE-style key
sets plus mouse deltas, so a camera path can be replayed from a text
script (the headless stand-in for interactive input; the port's copy of
``superconductor_tpu/render/rig.py``).
"""

from __future__ import annotations

import numpy as np

from ..math3d import Similarity, look_at, mat3_to_quat, mat4_inverse


def _exp_smooth_factor(smoothness: float, dt: float) -> float:
    """dolly's ExpSmoothed: interp = 1 - exp(-ln2 * dt / (smoothness/8))."""
    if smoothness <= 0.0:
        return 1.0
    half_life = smoothness / 8.0
    return 1.0 - float(np.exp(-np.log(2.0) * dt / max(half_life, 1e-6)))


class FlyCameraRig:
    """Position + YawPitch targets with exponential smoothing.

    yaw/pitch in degrees (yaw about +Y, pitch about the camera's right
    axis), matching the reference's dolly YawPitch stage.
    """

    def __init__(
        self,
        position=(0.0, 2.0, 8.0),
        yaw: float = 0.0,
        pitch: float = 0.0,
        position_smoothness: float = 1.0,
        rotation_smoothness: float = 0.5,
        speed: float = 4.0,
        look_speed: float = 60.0,
    ):
        self.target_pos = np.asarray(position, np.float32).copy()
        self.target_yaw = float(yaw)
        self.target_pitch = float(pitch)
        self.pos = self.target_pos.copy()
        self.yaw = self.target_yaw
        self.pitch = self.target_pitch
        self.position_smoothness = position_smoothness
        self.rotation_smoothness = rotation_smoothness
        self.speed = speed
        self.look_speed = look_speed

    # ---------------------------------------------------------- input --
    def _basis(self):
        """Forward/right/up of the TARGET orientation (y-up world)."""
        cy, sy = np.cos(np.radians(self.target_yaw)), np.sin(np.radians(self.target_yaw))
        cp, sp = np.cos(np.radians(self.target_pitch)), np.sin(np.radians(self.target_pitch))
        forward = np.array([-sy * cp, sp, -cy * cp], np.float32)
        right = np.array([cy, 0.0, -sy], np.float32)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        return forward, right, up

    def move(self, forward=0.0, right=0.0, up=0.0, dt=1.0 / 60.0, boost=1.0):
        f, r, u = self._basis()
        self.target_pos = (
            self.target_pos
            + (f * forward + r * right + u * up) * self.speed * boost * dt
        ).astype(np.float32)

    def rotate(self, dyaw=0.0, dpitch=0.0):
        """Degrees, immediate on the target (mouse input analog)."""
        self.target_yaw += dyaw
        self.target_pitch = float(np.clip(self.target_pitch + dpitch, -85.0, 85.0))

    def apply_keys(self, keys, dt=1.0 / 60.0, mouse=(0.0, 0.0)):
        """WASD/QE key set + mouse delta (pixels-ish) for one frame —
        handle_keyboard_input analog (demo/src/lib.rs:307-372)."""
        keys = {k.lower() for k in keys}
        self.move(
            forward=("w" in keys) - ("s" in keys),
            right=("d" in keys) - ("a" in keys),
            up=("e" in keys) - ("q" in keys),
            dt=dt,
            boost=4.0 if "shift" in keys else 1.0,
        )
        self.rotate(
            dyaw=-mouse[0] * self.look_speed * dt,
            dpitch=-mouse[1] * self.look_speed * dt,
        )

    def look_at(self, eye, center):
        """Set targets from an eye/center pair (scripted waypoints)."""
        eye = np.asarray(eye, np.float32)
        d = np.asarray(center, np.float32) - eye
        self.target_pos = eye.copy()
        self.target_yaw = float(np.degrees(np.arctan2(-d[0], -d[2])))
        self.target_pitch = float(
            np.degrees(np.arctan2(d[1], np.hypot(d[0], d[2])))
        )

    # --------------------------------------------------------- update --
    def update(self, dt: float = 1.0 / 60.0):
        """Advance smoothing; returns (position (3,), rotation quat (4,))."""
        tp = _exp_smooth_factor(self.position_smoothness, dt)
        tr = _exp_smooth_factor(self.rotation_smoothness, dt)
        self.pos = self.pos + (self.target_pos - self.pos) * tp
        # shortest-arc yaw: atan2-derived targets wrap at +-180 deg (an
        # orbiting look_at crosses it once per revolution); lerping the raw
        # difference would whip the camera the long way around
        dyaw = ((self.target_yaw - self.yaw + 180.0) % 360.0) - 180.0
        self.yaw += dyaw * tr
        self.pitch += (self.target_pitch - self.pitch) * tr

        cy, sy = np.cos(np.radians(self.yaw)), np.sin(np.radians(self.yaw))
        cp, sp = np.cos(np.radians(self.pitch)), np.sin(np.radians(self.pitch))
        forward = np.array([-sy * cp, sp, -cy * cp], np.float32)
        view = look_at(self.pos, self.pos + forward)
        rot = mat3_to_quat(mat4_inverse(view)[:3, :3])
        return self.pos.copy(), rot


def parse_camera_script(text: str):
    """Parse a camera script: one line per frame-range.

    Syntax per line (comments with #):
        <first>[-<last>] key1+key2+... [mouse=dx,dy]
    e.g.
        0-59   w
        60-89  w+d mouse=2,0
        90-120 mouse=-3,0.5
    Returns a dict frame -> (keys set, (dx, dy)).
    """
    frames = {}
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        rng = parts[0]
        keys = set()
        mouse = (0.0, 0.0)
        for tok in parts[1:]:
            if tok.startswith("mouse="):
                dx, dy = tok[6:].split(",")
                mouse = (float(dx), float(dy))
            else:
                keys |= {k for k in tok.split("+") if k}
        first, _, last = rng.partition("-")
        for f in range(int(first), int(last or first) + 1):
            frames[f] = (keys, mouse)
    return frames

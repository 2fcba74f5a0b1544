"""Debug visualization systems, mirroring src/systems/debugging.rs.

  * push_joints_to_lines: skeleton bones as lines between each joint's
    parent and child global positions (debugging.rs:8-41, built on
    AnimationJoints::iter_lines);
  * push_bounding_boxes_to_lines: the 24-segment box outline per visible
    primitive (debugging.rs:44-65 + BoundingBox line list, culling.rs:4-47);
  * push_test_particles: a ring of smoke puffs (debugging.rs:86-160).

Register any of these in Stage.INSTANCE_BUFFERING (after the frame's
buffers are cleared) and enable the matching RenderConfig flags. The
port's copy of ``superconductor_tpu/ecs/debugging.py``.
"""

from __future__ import annotations

import numpy as np

from .app import World
from .components import Instance, InstanceOf, JointsComponent, ModelComponent
from .resources import LineBuffer, ParticleBuffer

# color ids into the 16-entry debug palette (ops/lines.py)
SKELETON_COLOR = 8  # yellow
BBOX_COLOR = 5  # cyan


def push_joints_to_lines(world: World) -> None:
    lines = world.get_resource(LineBuffer)
    if lines is None:
        return
    for entity, jc, inst, of in world.query(JointsComponent, Instance, InstanceOf):
        mc = world.get(of.model_entity, ModelComponent)
        if mc is None or mc.model.depth_first_nodes is None:
            continue
        jc.joints.update(mc.model.depth_first_nodes)
        sim = inst.similarity
        for link in mc.model.depth_first_nodes.children:
            a = sim.apply_point(jc.joints.global_translation[link.parent])
            b = sim.apply_point(jc.joints.global_translation[link.index])
            lines.push(a, b, SKELETON_COLOR)


def _box_segments(mn, mx):
    """The 12 edges of an AABB as 12 segments (24 endpoints,
    culling.rs:17-47 uses the same edge set)."""
    c = [
        np.array([x, y, z], np.float32)
        for x in (mn[0], mx[0])
        for y in (mn[1], mx[1])
        for z in (mn[2], mx[2])
    ]
    edges = [
        (0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3),
        (2, 6), (3, 7), (4, 5), (4, 6), (5, 7), (6, 7),
    ]
    return [(c[a], c[b]) for a, b in edges]


def push_bounding_boxes_to_lines(world: World) -> None:
    lines = world.get_resource(LineBuffer)
    if lines is None:
        return
    for entity, inst, of in world.query(Instance, InstanceOf):
        mc = world.get(of.model_entity, ModelComponent)
        if mc is None:
            continue
        for prim in mc.model.primitives:
            if prim.bbox_min is None:
                continue
            sim = inst.similarity * prim.transform
            for a, b in _box_segments(prim.bbox_min, prim.bbox_max):
                lines.push(sim.apply_point(a), sim.apply_point(b), BBOX_COLOR)


def push_test_particles(world: World, count: int = 8, height: float = 1.5) -> None:
    pb = world.get_resource(ParticleBuffer)
    if pb is None:
        return
    for k in range(count):
        ang = 2 * np.pi * k / count
        pb.push(
            center=[2.0 * np.cos(ang), height, 2.0 * np.sin(ang)],
            scale=[1.0, 1.0],
            colour=[0.85, 0.85, 0.9],
            emissive_colour=[0.3, 0.2, 0.1],
        )

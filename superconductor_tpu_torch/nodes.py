"""glTF node hierarchy helpers: parent lookup and depth-first ordering.

Equivalent to the reference's ``NodeTree`` / ``DepthFirstNodes``
(the reference engine's gltf-helpers/src/lib.rs:106-174): ``NodeTree`` resolves a
node's global transform by walking parents; ``DepthFirstNodes`` gives an
iteration order (roots, then children whose parents precede them) so joint
hierarchies can be flattened in one pass per frame.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from .math3d import Similarity


@dataclass(frozen=True)
class ChildLink:
    index: int
    parent: int


class NodeTree:
    """Parent pointers + local transforms; global transform by parent walk."""

    def __init__(self, local_transforms: Sequence[Similarity], parents: Sequence[int]):
        # parents[i] == -1 for roots.
        self.local_transforms = list(local_transforms)
        self.parents = list(parents)

    @staticmethod
    def from_gltf_nodes(nodes: Sequence[dict]) -> "NodeTree":
        locals_ = [node_local_transform(n) for n in nodes]
        parents = [-1] * len(nodes)
        for i, node in enumerate(nodes):
            for child in node.get("children", ()):
                parents[child] = i
        return NodeTree(locals_, parents)

    def transform_of(self, index: int) -> Similarity:
        sim = self.local_transforms[index]
        parent = self.parents[index]
        while parent != -1:
            sim = self.local_transforms[parent] * sim
            parent = self.parents[parent]
        return sim

    def iter_depth_first(self) -> "DepthFirstNodes":
        return DepthFirstNodes.from_tree(self)


class DepthFirstNodes:
    """Roots plus a child list ordered so parents always come first."""

    def __init__(self, roots: List[int], children: List[ChildLink]):
        self.roots = roots
        self.children = children

    @staticmethod
    def from_tree(tree: NodeTree) -> "DepthFirstNodes":
        n = len(tree.parents)
        kids: Dict[int, List[int]] = {}
        roots = []
        for i, p in enumerate(tree.parents):
            if p == -1:
                roots.append(i)
            else:
                kids.setdefault(p, []).append(i)
        children: List[ChildLink] = []
        stack = list(reversed(roots))
        seen = [False] * n
        while stack:
            node = stack.pop()
            if seen[node]:
                continue
            seen[node] = True
            for c in kids.get(node, ()):  # preserve glTF child order
                children.append(ChildLink(index=c, parent=node))
                stack.append(c)
        # Depth-first requires children of earlier nodes to appear after their
        # parent link; a BFS-ish order also satisfies "parent before child",
        # which is the only invariant update() relies on. Re-sort to ensure it.
        order: Dict[int, int] = {r: 0 for r in roots}
        changed = True
        while changed:
            changed = False
            for link in children:
                if link.parent in order and link.index not in order:
                    order[link.index] = order[link.parent] + 1
                    changed = True
        children.sort(key=lambda link: order[link.index])
        return DepthFirstNodes(roots, children)

    def flatten_arrays(self):
        """(child_indices, parent_indices) as int32 arrays for vectorized use."""
        idx = np.array([c.index for c in self.children], dtype=np.int32)
        par = np.array([c.parent for c in self.children], dtype=np.int32)
        return idx, par


def node_local_transform(node: dict) -> Similarity:
    """Local Similarity from a raw glTF node dict (matrix or TRS)."""
    if "matrix" in node:
        m = np.asarray(node["matrix"], dtype=np.float32).reshape(4, 4).T
        return Similarity.from_mat4(m)
    return Similarity.from_gltf_trs(
        node.get("translation", (0.0, 0.0, 0.0)),
        node.get("rotation", (0.0, 0.0, 0.0, 1.0)),
        node.get("scale", (1.0, 1.0, 1.0)),
    )

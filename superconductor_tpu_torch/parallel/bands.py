"""Multi-device rendering: views and horizontal bands over a grid of
devices (the port of ``superconductor_tpu/parallel/bands.py``).

The reference shards a frame over a JAX ``Mesh`` with ``shard_map``: axis
"view" holds the stereo eyes, axis "band" splits the image into
horizontal bands. Every device repeats the geometry of its view (about 1%
of a frame) and runs binning, its band's tile raster and the deferred
shade; the scene tables are replicated like read-only weights, and the
image is gathered by the output sharding.

Here the grid is a ``RenderMesh`` of ``torch.device`` cells, and the
frame is a loop over them. The inputs (scene tables, ``FrameState``) are
copied once to each distinct device of the grid; ``EnvBindings`` holds
only ints and tuples and needs no copy. Each cell renders its band on its
device's current stream, on the frame's raster tiles that hold the band
(``frame_tile_rows``), so the image equals ``render_frame``'s byte for
byte; the bands are copied to the device of cell (0, 0), concatenated and
stacked there. Cells on different cards overlap
only as far as the host does not wait on one card before it launches on
the next: the frame path reads some counts back to the host, so today they
run one after another.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Sequence

import torch

from ..ops.tonemap import to_u8
from ..render.env import EnvBindings
from ..render.frame import FrameState, RenderConfig, render_view


class RenderMesh(NamedTuple):
    """A (num_views, n_bands) grid of devices with axes "view" and "band".

    The one departure from a JAX ``Mesh``: one device may fill several
    cells. Torch has one CPU device and a machine may have one card, so
    the grid is a schedule, not a set of distinct devices; cells on the
    same device run one after another on its current stream."""

    devices: tuple  # rows of torch.device, one row a view

    @property
    def axis_names(self) -> tuple:
        return ("view", "band")

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape``."""
        return {"view": len(self.devices), "band": len(self.devices[0])}

    def __getitem__(self, cell) -> torch.device:
        view, band = cell
        return self.devices[view][band]


def make_render_mesh(devices: Sequence = None, num_views: int = 1) -> RenderMesh:
    """Grid of `devices` (default: every visible CUDA device) with a view
    axis of `num_views` rows and a band axis of the rest; cells take the
    devices in order, row by row."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_render_mesh: no CUDA device is visible; pass `devices`")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if not devices or len(devices) % num_views:
        raise ValueError(f"{len(devices)} devices do not split into {num_views} views")
    n_bands = len(devices) // num_views
    return RenderMesh(tuple(tuple(devices[v * n_bands:(v + 1) * n_bands])
                            for v in range(num_views)))


def to_device(tree, device: torch.device):
    """`tree` (tensors in dicts, lists, tuples and NamedTuples; other
    leaves as they are) with every tensor on `device`. A tensor already
    there is the same tensor, not a copy."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def render_frame_sharded(scene: dict, state: FrameState, config: RenderConfig,
                         env: EnvBindings, mesh: RenderMesh) -> torch.Tensor:
    """Render every view with its bands spread over `mesh` -> (V, H, W, 4)
    u8 on the device of mesh[0, 0]. Cell (v, b) renders view v's rows
    [b * H / n_bands, (b + 1) * H / n_bands), computing the view's geometry
    itself, on the raster tiles of the frame that hold them
    (frame_tile_rows); the image equals render_frame's byte for byte
    (every worklist of a band is exact, as the reference says). No stats
    dict, as in the reference."""
    n_views, n_bands = mesh.shape["view"], mesh.shape["band"]
    if config.num_views != n_views:
        raise ValueError(f"config.num_views {config.num_views} != the mesh's {n_views} views")
    if config.height % n_bands:
        raise ValueError(f"height {config.height} is not a multiple of {n_bands} bands")
    config.resolve_raster()  # raises on an unknown method
    band_h = config.height // n_bands
    out = mesh[0, 0]
    replicas = {}
    views = []
    for v in range(n_views):
        bands = []
        for b in range(n_bands):
            dev = mesh[v, b]
            if dev not in replicas:
                replicas[dev] = to_device((scene, state), dev)
            scene_d, state_d = replicas[dev]
            y0, y1 = b * band_h, (b + 1) * band_h
            top, bottom = frame_tile_rows(y0, y1, config)
            with _on(dev):
                img, _stats = render_view(scene_d, state_d, v, config, env,
                                          band_height=bottom - top, y_offset=top)
                bands.append(to_u8(img[y0 - top:y1 - top]).to(out))
        views.append(torch.cat(bands))
    return torch.stack(views)


def frame_tile_rows(y0: int, y1: int, config: RenderConfig) -> tuple:
    """The rows [top, bottom) of the frame's raster tiles (config.tile_h
    rows each, from row 0) that hold the band [y0, y1). A cell renders
    these and keeps its band: the binned raster tests every pixel of each
    tile a triangle's bounding box touches, and the edge functions of a
    near-degenerate triangle can accept pixels outside its box, so a tile
    grid that started at y0 would let other such pixels through than the
    frame's grid does (5 pixels of the 1080p all-passes frame at 4 bands
    of 270 rows). On the frame's own tiles every band is byte-equal to
    render_frame's rows."""
    tile_h = config.tile_h
    return y0 - y0 % tile_h, min(-(-y1 // tile_h) * tile_h, config.height)

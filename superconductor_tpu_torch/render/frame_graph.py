"""One CUDA graph a frame: on a CUDA device, ``render_frame`` and
``render_frame_stats`` capture the frame body (``render_frame_impl``) once
per key and replay it.

After fit_caps every shape in the frame is static, and the frame path does
not synchronise with the host (worklists compact through a sort and
compose with a fixed-shape scatter; small host lists are made on the
device, ``ops.geometry.device_values``), so the whole frame captures. A
replay then costs the device's time, not the host's chain of launches.

* Key: the RenderConfig, the EnvBindings and ``with_stats``; each scene
  tensor's address, shape, dtype, strides and device (the graph reads the
  scene where it lies: a pool updated in place keeps the key, a re-gathered
  one is a new key) and the scene's other leaves; each FrameState tensor's
  shape, dtype, strides and device and the state's other leaves; the
  objects bound to the kernel wrappers' names (render/frame.py's raster
  and k-buffer, ops/sample.py's material samplers) and the kernels'
  split constants (ops/raster.py).
* Buffers: a graph owns a copy of every FrameState tensor. Each call copies
  the caller's tensors into them (device to device) before the replay, so
  a new pose, palette, line or particle set at the same shapes replays with
  the new values. The image (and the stats) come back as clones of the
  graph's outputs: a frame the caller still holds is never overwritten by
  the next replay.
* Capture: the first call at a key captures on a side stream, replays and
  returns the replay's frame; the first capture on a device follows one
  eager frame on that stream (lazy loading, per-stream library state). A
  capture that fails raises, naming the op that broke it. A device keeps
  CACHE_SIZE graphs, the least recently used evicted first; an evicted
  graph's memory goes back to the device when the next capture begins
  (``torch.cuda.graph`` empties the cache).
* Launch counts: a kernel launched during capture counts into the graph's
  tally (``ops.raster.capture_tally``) and each replay adds the tally, so
  the wrappers' LAUNCHES count the launches the device runs.
* Eager by design: CPU tensors, ``raster="ref"``, a call made while the
  current stream captures, and a frame in which a name of render/frame.py
  or a material sampler's name is bound to something other than at import
  (the plain-kernel twins, traces and per-pass counters rebind them, and a
  replay would not call them).
"""

from __future__ import annotations

import collections
from typing import Callable, NamedTuple

import torch

from ..ops import raster as raster_mod
from ..ops import sample as sample_mod
from . import frame as frame_mod

CACHE_SIZE = 3  # graphs kept a device
# the kernel wrappers the frame calls: (module, name), looked up at each call
KERNEL_NAMES = ((frame_mod, "rasterize_sorted"), (frame_mod, "kbuffer_sorted"),
                (sample_mod, "sample_classic"), (sample_mod, "sample_material"))
SPLIT_CONSTANTS = ("RASTER_CLUSTER", "RASTER_MIN_PART_ROWS", "KBUFFER_CLUSTER",
                   "KBUFFER_MIN_PART_ROWS", "KBUFFER_DEEP_CLUSTER")
# render/frame.py's functions and classes, and the kernel wrappers, as imported
_BOUND = {(frame_mod, name): obj for name, obj in vars(frame_mod).items() if callable(obj)}
_BOUND.update({(mod, name): getattr(mod, name) for mod, name in KERNEL_NAMES})


def frame_bindings_intact() -> bool:
    """Every function and class name of render/frame.py, and every kernel
    wrapper's name, is bound as at import."""
    return all(getattr(mod, name) is obj for (mod, name), obj in _BOUND.items())


def captures(state, config) -> bool:
    """True when render_frame replays a graph for this frame; False for
    the frames that run eagerly by design (see the module's docstring)."""
    return (state.joint_palette.device.type == "cuda"
            and config.resolve_raster() != "ref"
            and frame_bindings_intact()
            and not torch.cuda.is_current_stream_capturing())


def _flatten(tree, leaves: list, address: bool):
    """A hashable spec of a tree of dicts, tuples, lists and NamedTuples;
    its tensors are appended to `leaves` and stand in the spec as (shape,
    dtype, strides, device) and, with `address`, their data pointer."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return (torch.Tensor, tuple(tree.shape), tree.dtype, tree.stride(), tree.device,
                tree.data_ptr() if address else None)
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves, address)) for k, v in tree.items()))
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(v, leaves, address) for v in tree))
    return (None, tree)


def _unflatten(spec, leaves):
    """The tree of `spec` with the tensors taken in order from the
    iterator `leaves`."""
    kind, body = spec[0], spec[1]
    if kind is torch.Tensor:
        return next(leaves)
    if kind is None:
        return body
    if kind is dict:
        return {k: _unflatten(s, leaves) for k, s in body}
    items = [_unflatten(s, leaves) for s in body]
    return kind(*items) if hasattr(kind, "_fields") else kind(items)


def frame_key(scene: dict, state, config, env, with_stats: bool) -> tuple:
    """-> (the frame's key, the FrameState's spec, its tensors in the
    spec's order)."""
    leaves = []
    state_spec = _flatten(state, leaves, address=False)
    key = (config, env, bool(with_stats), _flatten(scene, [], address=True), state_spec,
           tuple(getattr(mod, name) for mod, name in KERNEL_NAMES),
           tuple(getattr(raster_mod, n) for n in SPLIT_CONSTANTS))
    return key, state_spec, leaves


class _Graph(NamedTuple):
    replay: Callable[[], None]
    inputs: list  # the graph's copies of the FrameState tensors
    outputs: object  # image, or (image, stats)
    tally: dict  # kernel launches a replay
    scene: dict  # held: the graph reads these tensors where they lie


def _clone(outputs):
    if isinstance(outputs, tuple):
        image, stats = outputs
        return image.clone(), {k: v.clone() for k, v in stats.items()}
    return outputs.clone()


_streams: dict = {}  # device -> the side stream frames are captured on
_warm: set = set()  # devices that ran their eager frame before a capture


def cuda_capture(body: Callable, device: torch.device):
    """Capture body() in a CUDA graph on the device's side stream ->
    (replay, body's outputs, which each replay rewrites)."""
    with torch.cuda.device(device):
        stream = _streams.get(device)
        if stream is None:
            stream = _streams[device] = torch.cuda.Stream(device)
        if device not in _warm:
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                body()
            torch.cuda.current_stream(device).wait_stream(stream)
            _warm.add(device)
        graph = torch.cuda.CUDAGraph()
        broke = []
        try:
            with torch.cuda.graph(graph, stream=stream):
                try:
                    outputs = body()
                except Exception as e:
                    broke.append(e)
                    raise
        except Exception as e:
            cause = broke[0] if broke else e
            raise RuntimeError(f"capturing the frame in a CUDA graph failed: {cause}") from cause
    return graph.replay, outputs


class FrameGraphs:
    """The captured frames of one device, the least recently used first.
    `capture(body, device) -> (replay, outputs)` makes a graph
    (cuda_capture)."""

    def __init__(self, device: torch.device, capture: Callable = cuda_capture):
        self.device = device
        self.capture = capture
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.captured = 0

    def __call__(self, scene: dict, state, config, env, with_stats: bool = False):
        key, state_spec, leaves = frame_key(scene, state, config, env, with_stats)
        graph = self.graphs.get(key)
        if graph is None:
            while len(self.graphs) >= CACHE_SIZE:
                self.graphs.popitem(last=False)
            graph = self.graphs[key] = self._capture(scene, state_spec, leaves, config, env,
                                                     with_stats)
        else:
            self.graphs.move_to_end(key)
        for dst, src in zip(graph.inputs, leaves):
            dst.copy_(src)
        graph.replay()
        raster_mod.replay_launches(graph.tally)
        return _clone(graph.outputs)

    def _capture(self, scene, state_spec, leaves, config, env, with_stats) -> _Graph:
        inputs = [t.clone() for t in leaves]
        state = _unflatten(state_spec, iter(inputs))

        def body():
            return frame_mod.render_frame_impl(scene, state, config, env,
                                               with_stats=with_stats)

        with raster_mod.capture_tally() as tally:
            replay, outputs = self.capture(body, self.device)
        self.captured += 1
        return _Graph(replay, inputs, outputs, dict(tally), scene)


_runners: dict = {}  # device -> FrameGraphs


def render(scene: dict, state, config, env, with_stats: bool = False):
    """The frame (render_frame_impl's result) from its device's graph for
    the frame's key, captured at the first call."""
    device = state.joint_palette.device
    runner = _runners.get(device)
    if runner is None:
        runner = _runners[device] = FrameGraphs(device)
    return runner(scene, state, config, env, with_stats)

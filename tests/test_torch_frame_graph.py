"""The frame without host syncs and its CUDA-graph runner
(superconductor_tpu_torch/render/frame_graph.py).

On the CPU: the fixed-shape worklist compose against the boolean-mask form
it replaced, byte for byte; the runner's bookkeeping (keys, the graph's
input buffers, fresh outputs, the cache) with the capture replaced by an
eager call on the graph's buffers; the launch tally. On the card (-m gpu):
the replayed frame against the eager frame at two poses, the launch
counters per replay, and a replay under torch.cuda.set_sync_debug_mode
("error")."""

import dataclasses

import numpy as np
import pytest
import torch

from superconductor_tpu_torch.ops import raster as raster_mod
from superconductor_tpu_torch.render import frame as frame_mod
from superconductor_tpu_torch.render import frame_graph
from superconductor_tpu_torch.render.caps import fit_caps
from superconductor_tpu_torch.render.frame import (
    RenderConfig,
    _compact_worklist,
    render_frame,
    render_frame_impl,
    render_frame_stats,
)
from superconductor_tpu_torch.scenes import STEREO_TINY, stereo_animated_scene

torch.set_num_threads(2)


# --- compose: a fixed-shape scatter, equal to the boolean-mask form --------

def _compose_by_mask(wl, dst, rows):
    """The boolean-mask compose the frame used before (a host sync)."""
    c = 1 if dst.ndim == 1 else dst.shape[-1]
    out = dst.clone().reshape(wl.npx // wl.gr, wl.gr * c)
    rows_g = rows.reshape(-1, wl.gr * c)
    out[wl.idx[wl.live].long()] = rows_g[wl.live]
    return out.reshape(dst.shape)


@pytest.mark.parametrize("gr", [1, 8])
@pytest.mark.parametrize("case", ["all_dead", "all_live", "seed0", "seed1", "seed2"])
def test_compose_equals_mask_form(gr, case):
    width, height = 64, 8
    npx = width * height
    config = RenderConfig(width=width, height=height, granule_px=gr)
    rng = np.random.default_rng(int(case[-1]) if case.startswith("seed") else 0)
    if case == "all_dead":
        mask, cap = np.zeros(npx, bool), npx // 4
    elif case == "all_live":
        mask, cap = np.ones(npx, bool), npx
    else:  # some granules past the cap, some lanes dead
        mask = rng.random(npx) < rng.uniform(0.05, 0.6)
        cap = int(rng.integers(npx // 8, npx // 2))
    wl = _compact_worklist(torch.from_numpy(mask), cap, config)
    assert wl.gr == gr
    lanes = wl.idx.shape[0] * gr
    for shape, dtype in (((npx,), torch.int32), ((npx, 3), torch.float32)):
        dst = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 100).to(dtype)
        rows = torch.from_numpy(
            rng.standard_normal((lanes,) + shape[1:]).astype(np.float32) * 100).to(dtype)
        got = wl.compose(dst, rows)
        want = _compose_by_mask(wl, dst, rows)
        assert got.shape == dst.shape and got.dtype == dst.dtype
        assert got.numpy().tobytes() == want.numpy().tobytes()
        if case == "all_dead":
            assert torch.equal(got, dst)


# --- the runner, its capture replaced by an eager call ----------------------

def _copy_tree(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_tree(dst[k], src[k])
    else:
        for a, b in zip(dst, src):
            _copy_tree(a, b)


def eager_capture(body, device):
    """A stand-in for cuda_capture: the outputs are made once, and each
    replay renders from the graph's buffers and writes into them."""
    outputs = body()
    return (lambda: _copy_tree(outputs, body())), outputs


@pytest.fixture(scope="module")
def tiny():
    dev, build, config, env = stereo_animated_scene(device="cpu", **STEREO_TINY)
    config = fit_caps(dev, build(0.0), config, env)
    return dev, build, config, env


def _new_view(state, dx: float):
    u = {k: v.clone() for k, v in state.uniforms.items()}
    u["view_proj"][:, 0, 3] += dx
    return state._replace(uniforms=u)


def _key(scene, state, config, env, with_stats=False):
    return frame_graph.frame_key(scene, state, config, env, with_stats)[0]


def test_key_changes_with_what_the_graph_bakes(tiny, monkeypatch):
    dev, build, config, env = tiny
    state = build(0.0)
    key = _key(dev, state, config, env)
    # a new pose and view at the same shapes: the same graph
    assert _key(dev, _new_view(build(1.3), 0.05), config, env) == key
    assert _key(dev, build(0.0), config, env) == key
    # what the graph bakes in: a new key
    longer = state._replace(joint_palette=torch.cat([state.joint_palette] * 2))
    assert _key(dev, longer, config, env) != key
    assert _key(dev, state, dataclasses.replace(config, shade_px_cap=config.shade_px_cap + 512),
                env) != key
    assert _key(dev, state, config, dataclasses.replace(env, clear_color=(0.5, 0.0, 0.0))) != key
    assert _key(dev, state, config, env, with_stats=True) != key
    regathered = dict(dev, texels=dev["texels"].clone())
    assert _key(regathered, state, config, env) != key
    in_place = dict(dev)  # the same tensors in another dict
    assert _key(in_place, state, config, env) == key
    monkeypatch.setattr(frame_mod, "rasterize_sorted", raster_mod.rasterize_sorted_plain)
    assert _key(dev, state, config, env) != key
    assert not frame_graph.frame_bindings_intact()
    monkeypatch.undo()
    assert frame_graph.frame_bindings_intact()
    monkeypatch.setattr(raster_mod, "KBUFFER_CLUSTER", raster_mod.KBUFFER_CLUSTER * 2)
    assert _key(dev, state, config, env) != key


def test_runner_renders_each_call_from_its_inputs(tiny):
    dev, build, config, env = tiny
    runner = frame_graph.FrameGraphs(torch.device("cpu"), capture=eager_capture)
    state_a = build(0.0)
    state_b = _new_view(build(1.3), 0.05)  # new view matrix and palettes
    assert not torch.equal(state_a.joint_palette, state_b.joint_palette)
    img_a = runner(dev, state_a, config, env)
    img_b = runner(dev, state_b, config, env)
    assert runner.captured == 1 and len(runner.graphs) == 1
    want_a = render_frame_impl(dev, state_a, config, env)
    want_b = render_frame_impl(dev, state_b, config, env)
    assert not torch.equal(want_a, want_b)
    assert torch.equal(img_a, want_a) and torch.equal(img_b, want_b)
    # outputs are fresh tensors: the later replay left the first frame alone
    (graph,) = runner.graphs.values()
    assert img_a.data_ptr() != img_b.data_ptr()
    assert graph.outputs.data_ptr() not in (img_a.data_ptr(), img_b.data_ptr())
    # the caller's state is copied in, never held
    assert all(t.data_ptr() not in {s.data_ptr() for s in graph.inputs}
               for t in (state_b.joint_palette, state_b.uniforms["view_proj"]))

    img, stats = runner(dev, state_b, config, env, with_stats=True)
    want_img, want_stats = render_frame_impl(dev, state_b, config, env, with_stats=True)
    assert runner.captured == 2 and torch.equal(img, want_img)
    assert stats.keys() == want_stats.keys()
    assert all(torch.equal(stats[k], want_stats[k]) for k in stats)
    (_, graph_s) = runner.graphs.values()
    assert all(stats[k].data_ptr() != graph_s.outputs[1][k].data_ptr() for k in stats)


def test_runner_keeps_the_most_recent_graphs(tiny):
    dev, build, config, env = tiny
    runner = frame_graph.FrameGraphs(torch.device("cpu"), capture=eager_capture)
    state = build(0.0)
    size = frame_graph.CACHE_SIZE
    configs = [dataclasses.replace(config, shade_px_cap=config.shade_px_cap + 512 * i)
               for i in range(size + 1)]
    for c in configs[:size]:
        runner(dev, state, c, env)
    runner(dev, state, configs[0], env)  # a hit: configs[1] is now the oldest
    assert runner.captured == size
    runner(dev, state, configs[size], env)
    assert runner.captured == size + 1 and len(runner.graphs) == size
    runner(dev, state, configs[0], env)
    assert runner.captured == size + 1  # kept
    runner(dev, state, configs[1], env)
    assert runner.captured == size + 2  # evicted, so captured again


def test_cpu_frames_stay_eager(tiny):
    dev, build, config, env = tiny
    state = build(0.5)
    assert not frame_graph.captures(state, config)
    assert torch.equal(render_frame(dev, state, config, env),
                       render_frame_impl(dev, state, config, env))
    img, stats = render_frame_stats(dev, state, config, env)
    assert torch.equal(img, render_frame_impl(dev, state, config, env))
    assert not frame_graph._runners


def test_replay_launches_adds_the_tally():
    before = (raster_mod.rasterize_sorted.LAUNCHES, raster_mod.kbuffer_sorted.LAUNCHES)
    with raster_mod.capture_tally() as tally:
        assert raster_mod._tallies[-1] is tally
    assert tally not in raster_mod._tallies
    for _ in range(4):
        raster_mod.replay_launches({raster_mod.rasterize_sorted: 2,
                                    raster_mod.kbuffer_sorted: 3})
    assert raster_mod.rasterize_sorted.LAUNCHES == before[0] + 8
    assert raster_mod.kbuffer_sorted.LAUNCHES == before[1] + 12


# --- on the card ------------------------------------------------------------

def _card_frame():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    dev, build, config, env = stereo_animated_scene(device="cuda", **STEREO_TINY)
    return dev, build, fit_caps(dev, build(0.0), config, env), env


def _launches():
    return (raster_mod.rasterize_sorted.LAUNCHES, raster_mod.kbuffer_sorted.LAUNCHES)


@pytest.mark.gpu
def test_graph_frame_equals_eager_on_card():
    dev, build, config, env = _card_frame()
    for t in (0.4, 1.7):
        state = build(t)
        assert frame_graph.captures(state, config)
        img, stats = render_frame_stats(dev, state, config, env)
        want, want_stats = render_frame_impl(dev, state, config, env, with_stats=True)
        assert torch.equal(img, want)
        assert all(torch.equal(stats[k], want_stats[k]) for k in stats)
        assert torch.equal(render_frame(dev, state, config, env), want)


@pytest.mark.gpu
def test_launch_counters_count_replays_on_card():
    dev, build, config, env = _card_frame()
    state = build(0.2)
    render_frame(dev, state, config, env)  # the capture
    l0 = _launches()
    render_frame_impl(dev, state, config, env)
    eager = tuple(b - a for a, b in zip(l0, _launches()))
    assert eager[0] > 0
    for n in (1, 3):
        l0 = _launches()
        for _ in range(n):
            render_frame(dev, build(0.2 * n), config, env)
        assert tuple(b - a for a, b in zip(l0, _launches())) == tuple(n * e for e in eager)


@pytest.mark.gpu
def test_replay_does_not_synchronise_on_card():
    dev, build, config, env = _card_frame()
    render_frame(dev, build(0.0), config, env)
    state = build(0.9)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img = render_frame(dev, state, config, env)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(img, render_frame_impl(dev, state, config, env))

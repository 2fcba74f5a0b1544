"""The deferred stages' kernel wrappers on the CPU: ops/shade.py
interpolate_gbuffer and ops/sky.py sample_skybox / sample_skybox_at (the
wrappers of csrc/gbuffer.cu and csrc/sky.cu, which take their plain
versions for CPU tensors; tests/test_torch_deferred_card.py holds the
kernels to those on the card, tests/test_torch_sky.py and
tests/test_torch_shade.py the plain versions to the JAX package).

The frame reaches the three wrappers by the names render/frame.py binds;
rebinding any of them changes frame_graph's key and sends the frame eager;
the plain-versions twin (bench.plain_versions) swaps all three; off the
CPU a wrapper raises on any input its kernel does not take, and on any
device but CUDA, rather than run a plain path; a CPU call counts no
launch. The sky kernel's host-side pieces: the divisor its worklist
divides by, and the template a launch picks."""

import dataclasses

import numpy as np
import pytest
import torch

from superconductor_tpu_torch import bench, profile_frame
from superconductor_tpu_torch.ops import shade as port_shade
from superconductor_tpu_torch.ops import sky as port_sky
from superconductor_tpu_torch.render import frame as frame_mod
from superconductor_tpu_torch.render import frame_graph
from superconductor_tpu_torch.render.caps import fit_caps
from superconductor_tpu_torch.render.frame import render_frame_impl
from superconductor_tpu_torch.scenes import headline_scene
from test_torch_deferred_card import SKY_CASES, gbuffer_args, sky_args

torch.set_num_threads(2)

NAMES = ("interpolate_gbuffer", "sample_skybox", "sample_skybox_at")


def test_frame_calls_the_wrappers_by_its_names(monkeypatch):
    """A CPU frame calls the three wrappers where render/frame.py binds
    them: the headline over the whole band and on a sky worklist; each
    wrapper is the function its module defines, and a CPU call counts no
    launch."""
    calls = []
    for name in NAMES:
        assert getattr(frame_mod, name) is getattr(
            port_shade if name == "interpolate_gbuffer" else port_sky, name)
        real = getattr(frame_mod, name)

        def counted(*args, _name=name, _real=real, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(frame_mod, name, counted)
    launches = [port_shade.interpolate_gbuffer.LAUNCHES, port_sky.sample_skybox.LAUNCHES,
                port_sky.sample_skybox_at.LAUNCHES]
    dev, build, config, env = headline_scene(128, 64, "cpu")
    state = build(0.0)
    config = fit_caps(dev, state, config, env)
    for sky_px_cap in (None, 128 * 64 // 2):
        render_frame_impl(dev, state, dataclasses.replace(config, sky_px_cap=sky_px_cap), env)
    assert set(calls) == set(NAMES)
    assert [port_shade.interpolate_gbuffer.LAUNCHES, port_sky.sample_skybox.LAUNCHES,
            port_sky.sample_skybox_at.LAUNCHES] == launches


@pytest.mark.parametrize("name", NAMES)
def test_rebinding_a_deferred_wrapper_changes_the_graph_key(name, monkeypatch):
    scene, state = {"t": torch.zeros(3)}, (torch.zeros(2),)
    key = frame_graph.frame_key(scene, state, None, None, False)[0]
    assert frame_graph.frame_bindings_intact()
    assert (frame_mod, name) in frame_graph.KERNEL_NAMES
    plain = getattr(port_shade if name == "interpolate_gbuffer" else port_sky, name + "_plain")
    monkeypatch.setattr(frame_mod, name, plain)
    assert frame_graph.frame_key(scene, state, None, None, False)[0] != key
    assert not frame_graph.frame_bindings_intact()
    monkeypatch.undo()
    assert frame_graph.frame_bindings_intact()
    assert frame_graph.frame_key(scene, state, None, None, False)[0] == key


def test_plain_versions_swap_every_deferred_wrapper():
    """bench.plain_versions puts the plain versions where the frame looks
    the wrappers up, and puts the wrappers back after; profile_frame counts
    the two kernels as hand kernels."""
    with bench.plain_versions(("gbuffer", "sky")):
        assert frame_mod.interpolate_gbuffer is port_shade.interpolate_gbuffer_plain
        assert frame_mod.sample_skybox is port_sky.sample_skybox_plain
        assert frame_mod.sample_skybox_at is port_sky.sample_skybox_at_plain
    assert frame_graph.frame_bindings_intact()
    for kernel in ("void (anonymous namespace)::gbuffer_kernel<true>(int, int const*)",
                   "void (anonymous namespace)::sky_kernel<1>((anonymous namespace)::SkyArgs)"):
        assert profile_frame.HAND_KERNEL.search(kernel)


def _meta(args: dict) -> dict:
    def to_meta(v):
        if isinstance(v, torch.Tensor):
            return v.to("meta")
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*[to_meta(x) for x in v])
        if isinstance(v, dict):
            return {k: to_meta(x) for k, x in v.items()}
        return v

    return {k: to_meta(v) for k, v in args.items()}


GBUFFER_FAULTS = {
    "pair-dtype": lambda a: dict(a, pair=a["pair"].long()),
    "px-shape": lambda a: dict(a, px=a["px"][:-1]),
    "py-dtype": lambda a: dict(a, py=a["py"].double()),
    "row-narrow": lambda a: dict(a, shade_row=a["shade_row"][:, :40]),
    "row_cols-wide": lambda a: dict(a, row_cols=a["shade_row"].shape[1] + 1),
    "row-dtype": lambda a: dict(a, shade_row=a["shade_row"].double()),
    "row-columns-strided": lambda a: dict(a, shade_row=a["shade_row"].t().contiguous().t()),
    "cpu-row": lambda a: dict(a, shade_row=torch.zeros(a["shade_row"].shape)),
    "unpacked": lambda a: dict(a, shade_row=None,
                               attrs=a["attrs"]._replace(packed=None)),
}


@pytest.mark.parametrize("fault", sorted(GBUFFER_FAULTS) + ["none"])
def test_gbuffer_wrapper_raises_off_the_cpu(fault):
    """Meta tensors stand in for a card's: every input the kernel does not
    take raises, and a good one raises too, off CUDA (no plain path)."""
    args = _meta(gbuffer_args("shade"))
    if fault != "none":
        args = GBUFFER_FAULTS[fault](args)
    with pytest.raises((ValueError, TypeError),
                       match="CUDA tensors" if fault == "none" else None):
        port_shade.interpolate_gbuffer(**args)


SKY_FAULTS = {
    "m-shape": lambda a: dict(a, projection_inverse=a["projection_inverse"][:3]),
    "q-dtype": lambda a: dict(a, view_quat=a["view_quat"].double()),
    "pool-width": lambda a: dict(a, scene=dict(a["scene"], texels_hdr_q=torch.zeros(
        (8, 8), device="meta"))),
    "pool-dtype": lambda a: dict(a, scene=dict(a["scene"], texels_hdr_q=torch.zeros(
        (8, 16), dtype=torch.int32, device="meta"))),
    "cpu-pool": lambda a: dict(a, scene=dict(a["scene"], texels_hdr_q=torch.zeros((8, 16)))),
    "width": lambda a: dict(a, width=0),
}


@pytest.mark.parametrize("fault", sorted(SKY_FAULTS) + ["none", "none-desc", "at-idx-dtype",
                                                        "at-full-height", "at-none"])
def test_sky_wrappers_raise_off_the_cpu(fault):
    case = {"none-desc": "desc-quad-f16"}.get(fault, "static-quad-f16")
    if fault.startswith("at-"):
        case = "static-quad-f16-at-i32"
    name, args = sky_args(case)
    args = _meta(args)
    if fault in SKY_FAULTS:
        args = SKY_FAULTS[fault](args)
    elif fault == "at-idx-dtype":
        args["idx"] = args["idx"].to(torch.int16)
    elif fault == "at-full-height":
        args["full_height"] = None
    with pytest.raises((ValueError, TypeError),
                       match="CUDA tensors" if fault.startswith(("none", "at-none")) else None):
        getattr(port_sky, name)(**args)


def _kernel_floor_div(i: int, d: int) -> tuple:
    """(row, col) of int32 i by width d as csrc/sky.cu floor_div32 and
    index_coords32 compute them from ops/sky.py fast_divisor's pair (32-bit
    unsigned arithmetic)."""
    mul, shift = port_sky.fast_divisor(d)
    s = -1 if i < 0 else 0
    n = (i ^ s) & 0xFFFFFFFF
    q = ((n * mul) >> 32) >> shift if mul else n
    row = q ^ s
    col = (i - row * d) & 0xFFFFFFFF
    return row, col - (1 << 32) if col >= 1 << 31 else col


@pytest.mark.parametrize("width", [1, 2, 3, 61, 64, 1920, 65537, 2 ** 30 + 1, 2 ** 31 - 1])
def test_fast_divisor_floor_divides(width):
    """The kernel's worklist division: the floor quotient and modulo of
    every int32 index, negative ones and INT32_MIN among them, by the
    band's width (torch.div(rounding_mode="floor") and torch.remainder)."""
    mul, shift = port_sky.fast_divisor(width)
    assert 0 <= mul < 2 ** 32 and 0 <= shift < 32
    rng = np.random.default_rng(width % 1000)
    near = [k * width + e for k in (0, 1, 2, 7, -1, -2, -7) for e in (-1, 0, 1)]
    values = near + [0, 1, -1, 2 ** 31 - 1, -2 ** 31, -2 ** 31 + 1, 2 ** 31 - 2] + \
        rng.integers(-2 ** 31, 2 ** 31, size=2000).tolist()
    for i in values:
        if -2 ** 31 <= i < 2 ** 31:
            assert _kernel_floor_div(i, width) == (i // width, i % width), i


@pytest.mark.parametrize("case", sorted(SKY_CASES))
def test_kernel_variant_names_the_launch(case):
    """The template the wrapper launches: band or worklist, the pool's
    texel type and layout (the clear colour without a cubemap), the
    placement and the two inline flags."""
    pool, texel, placement, _camera, (tm, srgb), _band, idx_dtype = SKY_CASES[case]
    name, args = sky_args(case)
    want = (int(idx_dtype is None), {"u8": 0, "f16": 1, "f32": 2}[texel], int(pool == "quad"),
            int(placement == "static"), int(tm), int(srgb))
    if placement == "clear":
        want = want[:1] + (3, 0, 0) + want[4:]
    got = port_sky.kernel_variant(args["scene"], args["env"], name == "sample_skybox", tm, srgb)
    assert got == want

"""The particle pass's CUDA kernels against their plain versions on the card,
bit for bit: ops/particles.py shade_particles (csrc/shade.cu
shade_kernel(ParticleShadeArgs)) and particle_geometry (csrc/geometry.cu
view_setup_kernel(ParticleQuadArgs)). This file imports no JAX: its tests
run only where there is a card (-m gpu) and skip elsewhere.

    python -m pytest -q -m gpu tests/test_torch_particles_card.py

The cases also serve tests/test_torch_particles.py, which holds the plain
versions to the JAX package and the wrappers' checks on the CPU:

* the lit_passes scene at 256 x 128 (LIT_PASSES_SMALL: a light volume,
  lightmaps, the smoke pool and its LUT) and the all-passes camera at
  256 x 128 and 1920 x 1080;
* particles (PARTICLES): the all-passes 16, every odd one reading the
  emissive LUT, and 30 seeded ones (some behind the eye, two of zero
  scale, one invalid), packed to 64;
* the smoke branches (SMOKE): the procedural puff (no smoke textures), the
  smoke pool, the maps per slot from the LDR quad pool and from the flat
  pool; the SH (SH): the constant ambient values, the light volume, the
  lightmaps;
* lanes: pairs drawn from the valid billboard rows, every 23rd dead (-1),
  pixel centres inside each pair's box.
"""

import dataclasses
import functools
import inspect

import numpy as np
import pytest
import torch

from superconductor_tpu_torch.ops import particles as port_particles
from superconductor_tpu_torch.ops.shade import GBuffer, PoolSH, sample_spherical_harmonics
from superconductor_tpu_torch.render.camera import Camera, make_uniforms
from superconductor_tpu_torch.render.draws import pack_particles
from superconductor_tpu_torch.scene.upload import scene_to_torch
from superconductor_tpu_torch.scenes import (
    ALL_PASSES_EYE,
    ALL_PASSES_TARGET,
    LIT_PASSES_SMALL,
    _aim,
    lit_passes_host,
)
from superconductor_tpu_torch import math3d

torch.set_num_threads(2)

SMOKE = ("puff", "pool", "slots", "slots-flat")
SH = ("ambient", "volume", "lightmap")
SIZES = ((256, 128), (1920, 1080))
LANES = (1, 512, 589_824)
AMBIENT_SH = (0.8, 0.7, 0.6, 0.25, -0.1, 0.05, 0.3, 0.35, 0.2, -0.15, 0.1, 0.4)


@functools.lru_cache(maxsize=None)
def lit_host():
    """The small lit scene's host side (scenes.lit_passes_host)."""
    return lit_passes_host(**LIT_PASSES_SMALL)


@functools.lru_cache(maxsize=None)
def uniforms_at(width: int, height: int) -> dict:
    """The all-passes camera's uniforms at width x height with the lit
    scene's probe box, as numpy arrays."""
    cam = Camera(position=np.array(ALL_PASSES_EYE, np.float32))
    _aim(cam, list(ALL_PASSES_TARGET), math3d)
    u = make_uniforms(cam, width, height)
    lit_u = lit_host()[2]
    u.probes_bottom_left = lit_u.probes_bottom_left
    u.probes_scale = lit_u.probes_scale
    return {k: np.asarray(v, np.float32) for k, v in u.as_device_dict().items()}


def particle_dicts(seed: int = 6) -> list:
    """The all-passes 16 particles, every odd one reading the emissive LUT
    at lut_y (k + 0.5) / 16, then 30 seeded ones: uv transforms, LUT flags,
    centres around the ring and some behind the eye, two of zero scale."""
    base = []
    for k in range(16):
        base.append({"center": [3.0 * np.cos(0.8 * k), 1.0 + 0.2 * k, 3.0 * np.sin(0.8 * k)],
                     "scale": [1.5, 1.5], "colour": [0.9, 0.9, 0.95],
                     "emissive_colour": [0.3, 0.2, 0.1], "use_emissive_lut": k % 2,
                     "lut_y": (k + 0.5) / 16.0 if k % 2 else 0.0})
    rng = np.random.default_rng(seed)
    for i in range(30):
        centre = rng.uniform(-6.0, 6.0, size=3)
        if i % 7 == 0:  # behind the eye
            centre = np.array(ALL_PASSES_EYE) + rng.uniform(0.5, 3.0) * (
                np.array(ALL_PASSES_EYE) - np.array(ALL_PASSES_TARGET))
        base.append({
            "center": centre.tolist(),
            "scale": [0.0, 0.0] if i in (3, 4) else rng.uniform(0.05, 3.0, size=2).tolist(),
            "colour": rng.uniform(0.0, 1.0, size=3).tolist(),
            "uv_offset": rng.uniform(-0.2, 0.2, size=2).tolist(),
            "uv_scale": rng.uniform(0.5, 1.5, size=2).tolist(),
            "emissive_colour": rng.uniform(0.0, 0.5, size=3).tolist(),
            "use_emissive_lut": int(i % 3 == 0),
            "lut_y": float(rng.uniform()),
        })
    return base


@functools.lru_cache(maxsize=None)
def particle_soa(seed: int = 6) -> dict:
    """pack_particles of particle_dicts (64 slots), one of them invalid."""
    soa = pack_particles(particle_dicts(seed))
    soa["valid"][20] = False
    return soa


def to_device(soa: dict, device) -> dict:
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in soa.items()}


def env_for(smoke: str, sh: str):
    """The lit scene's EnvBindings cut to one smoke branch and one SH
    source."""
    env = lit_host()[3]
    if sh == "ambient":
        env = dataclasses.replace(env, lightvol_tex_ids=None, lightvol_wh=None,
                                  lightmap_tex_ids=None, lightmap_wh=None,
                                  ambient_sh=AMBIENT_SH)
    elif sh == "volume":
        env = dataclasses.replace(env, lightmap_tex_ids=None, lightmap_wh=None)
    elif sh == "lightmap":
        env = dataclasses.replace(env, lightvol_tex_ids=None, lightvol_wh=None)
    if smoke == "puff":
        env = dataclasses.replace(env, smoke_tex_ids=None, smoke_static=None)
    return env


@functools.lru_cache(maxsize=None)
def _scene_tables(device: str) -> dict:
    return scene_to_torch(lit_host()[0], device)


def scene_for(smoke: str, device) -> dict:
    """The lit scene's tables on `device`, without the smoke pool for the
    per-slot branches and without the quad pool for the flat one."""
    d = dict(_scene_tables(str(device)))
    if smoke.startswith("slots"):
        d.pop("smoke_ab")
        d.pop("smoke_lut")
    if smoke == "slots-flat":
        d.pop("texels_q")
    return d


def sh_sampler(scene: dict, u: dict, env):
    """The frame's SH sampler (render/frame.py render_view): the SH over a
    stand-in g-buffer that holds only the world position."""
    def sample(world_pos):
        n = world_pos.shape[0]
        stand_in = GBuffer(
            valid=None, world_pos=world_pos, normal=None, uv=None,
            lm_uv=torch.zeros_like(world_pos[..., :2]), material=None, front_facing=None,
            lightmapped=torch.zeros(n, dtype=torch.bool, device=world_pos.device),
            dpdx=None, dpdy=None, duvdx=None, duvdy=None)
        return sample_spherical_harmonics(stand_in, scene, u, env)
    return sample


def lanes_for(tri_valid: np.ndarray, bbox: np.ndarray, lanes: int, seed: int) -> tuple:
    """(pair, px, py) numpy: pairs drawn from the valid rows, every 23rd
    -1, pixel centres inside each pair's box."""
    rng = np.random.default_rng(seed)
    valid = np.where(tri_valid)[0]
    pair = rng.choice(valid, size=lanes).astype(np.int32)
    pair[::23] = -1
    box = bbox[np.maximum(pair, 0)]
    px = rng.integers(box[:, 0], box[:, 2] + 1).astype(np.float32) + 0.5
    py = rng.integers(box[:, 1], box[:, 3] + 1).astype(np.float32) + 0.5
    return pair, px, py


def shade_case(smoke: str, sh: str, lanes: int, device, size=(256, 128), seed: int = 9,
               inline=(True, True), sampler: str = "pool") -> dict:
    """shade_particles' arguments by name for one case, on `device`: the
    billboards of PARTICLES under the all-passes camera at `size`
    (particle_geometry_plain), `lanes` lanes on them; the SH sampler the
    frame's PoolSH, or with sampler "foreign" the same chain as a closure
    (sh_sampler), which the wrapper cannot read in place."""
    u_np = uniforms_at(*size)
    u = {k: torch.from_numpy(v).to(device) for k, v in u_np.items()}
    soa = to_device(particle_soa(), device)
    tri, attrs = port_particles.particle_geometry_plain(
        soa, u["view"][0], u["view_inverse"][0], u["projection"][0], *size)
    pair, px, py = lanes_for(tri.valid.cpu().numpy(), tri.bbox.cpu().numpy(), lanes, seed)
    scene, env = scene_for(smoke, device), env_for(smoke, sh)
    return dict(pair=torch.from_numpy(pair).to(device), px=torch.from_numpy(px).to(device),
                py=torch.from_numpy(py).to(device), tri=tri, attrs=attrs, particles=soa,
                scene=scene, uniforms=u, env=env, view_index=0,
                sh_sampler=(PoolSH if sampler == "pool" else sh_sampler)(scene, u, env),
                inline_tonemapping=inline[0], inline_srgb=inline[1])


def geometry_args(size, device, flip=False, soa=None) -> dict:
    u = {k: torch.from_numpy(v).to(device) for k, v in uniforms_at(*size).items()}
    return dict(particles=to_device(particle_soa() if soa is None else soa, device),
                view=u["view"][0], view_inverse=u["view_inverse"][0],
                projection=u["projection"][0], width=size[0], height=size[1],
                flip_viewport=flip)


# --- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (csrc/shade.cu and csrc/geometry.cu have no CPU mode)")
    return torch.device("cuda", 0)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
    return torch.equal(a, b)


def _shade_launches(args: dict) -> int:
    """One launch with the ambient SH or a pooled PoolSH, else two."""
    ambient = args["env"].lightvol_tex_ids is None and args["env"].lightmap_tex_ids is None
    pooled = isinstance(args["sh_sampler"], PoolSH) and args["sh_sampler"].pooled()
    return 1 if ambient or pooled else 2


def _check_shade(args: dict) -> None:
    before = port_particles.shade_particles.LAUNCHES
    rgb, alpha = port_particles.shade_particles(**args)
    torch.cuda.synchronize()
    assert port_particles.shade_particles.LAUNCHES - before == _shade_launches(args)
    want_rgb, want_alpha = port_particles.shade_particles_plain(**args)
    bad = int((rgb.view(torch.int32) != want_rgb.view(torch.int32)).sum())
    assert bad == 0, f"{bad} of {rgb.numel()} rgb values differ"
    assert _bits_equal(alpha, want_alpha)


# the frame's PoolSH (one launch) and the same chain as a closure (two
# launches around it where a light volume or lightmaps are bound)
SAMPLERS = ("pool", "foreign")


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", SAMPLERS)
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("sh", SH)
@pytest.mark.parametrize("smoke", SMOKE)
def test_shade_kernel_equals_plain_on_card(smoke, sh, lanes, sampler):
    """Every smoke branch and SH source at a layer of 1, 512 and 589,824
    lanes, by either sampler: rgb and alpha bit for bit, one launch (the
    ambient SH, or the SH pools sampled in the launch) or two (the
    position launch and the full one around a foreign sampler)."""
    _check_shade(shade_case(smoke, sh, lanes, _card(), sampler=sampler))


@pytest.mark.gpu
@pytest.mark.parametrize("sh", ["volume", "lightmap", "both"])
def test_shade_kernel_foreign_sampler_takes_two_launches_on_card(sh):
    """A sampler that is not a PoolSH (or a PoolSH without its pools):
    the position launch, the sampler, the full launch, bit for bit."""
    dev = _card()
    _check_shade(shade_case("pool", sh, 4096, dev, sampler="foreign"))
    args = shade_case("pool", sh, 4096, dev)
    layered = {k: v for k, v in args["scene"].items() if k not in ("lv_sh", "lm_sh")}
    args = dict(args, scene=layered, sh_sampler=PoolSH(layered, args["uniforms"], args["env"]))
    assert _shade_launches(args) == 2
    _check_shade(args)


# probe boxes over the billboards: the lit scene's; a small one, so that
# most positions fall outside it on every side (the clamped texels and
# layers, the negative edge); one whose bottom-left corner is a particle's
# centre, so that the positions straddle the box's lower faces
BOXES = ("lit", "small", "corner")


def _with_box(args: dict, box: str) -> dict:
    u = dict(args["uniforms"])
    if box == "small":
        u["probes_scale"] = u["probes_scale"] * 0.05
    elif box == "corner":
        u["probes_bottom_left"] = args["particles"]["center"][0].clone()
    pool = PoolSH(args["scene"], u, args["env"])
    return dict(args, uniforms=u, sh_sampler=pool)


@pytest.mark.gpu
@pytest.mark.parametrize("box", BOXES)
@pytest.mark.parametrize("sh", ["volume", "lightmap", "both"])
def test_shade_kernel_sh_pools_on_card(sh, box):
    """The SH sampled in the launch at each lane's position: the light
    volume alone, the lightmaps alone (every lane at uv 0), both (the
    volume: the stand-in is not lightmapped), under each probe box, one
    launch, bit for bit; the torch sampler does not run."""
    dev = _card()
    args = _with_box(shade_case("pool", sh, 65_536, dev, size=(1920, 1080)), box)
    calls = sample_spherical_harmonics.CALLS
    rgb, alpha = port_particles.shade_particles(**args)
    torch.cuda.synchronize()
    assert sample_spherical_harmonics.CALLS == calls
    want_rgb, want_alpha = port_particles.shade_particles_plain(**args)
    assert _bits_equal(rgb, want_rgb) and _bits_equal(alpha, want_alpha)


def _dead_tail(args: dict, live: int, period: int, seed: int) -> dict:
    """The lanes of `args` with every lane from `live` on dead (pair -1),
    their pixel centres repeating every `period` lanes (0: none repeats)."""
    n = args["pair"].shape[0]
    rng = np.random.default_rng(seed)
    pair = args["pair"].clone()
    pair[live:] = -1
    px, py = args["px"].clone(), args["py"].clone()
    tail = n - live
    if period:
        idx = torch.arange(tail, device=px.device) % period
        px[live:], py[live:] = px[live:live + period][idx], py[live:live + period][idx]
    else:
        px[live:] = torch.from_numpy(rng.uniform(0, 1920, size=tail).astype(np.float32)).to(px.device)
        py[live:] = torch.from_numpy(rng.uniform(0, 1080, size=tail).astype(np.float32)).to(px.device)
    return dict(args, pair=pair, px=px, py=py)


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", SAMPLERS)
@pytest.mark.parametrize("lanes", [300_000, 589_824])
@pytest.mark.parametrize("tail", ["periodic-128", "periodic-96", "not-periodic", "all-dead"])
def test_shade_kernel_dead_tails_on_card(tail, lanes, sampler):
    """Lanes past a live prefix dead, their pixel centres repeating every
    granule (as the frame's compaction leaves them), every 96 lanes (a
    period no stride is a multiple of) or not at all, at 300,000 and
    589,824 lanes (runs of several lanes at the card's resident threads)
    and by either sampler (the position launch copies down the runs too):
    bit for bit."""
    dev = _card()
    args = shade_case("pool", "volume", lanes, dev, size=(1920, 1080), sampler=sampler)
    live = 0 if tail == "all-dead" else 12_345
    period = {"periodic-128": 128, "periodic-96": 96}.get(tail, 0 if tail != "all-dead" else 128)
    _check_shade(_dead_tail(args, live, period, 5))


@pytest.mark.gpu
@pytest.mark.parametrize("live", [0, 1000])
def test_shade_kernel_given_sh_is_not_reused_on_card(live):
    """With a foreign sampler whose SH is not a function of the position
    (a value a lane), equal keys (a periodic dead tail over 589,824 lanes,
    runs of several lanes at the card's resident threads) must not take a
    copied result: bit for bit with the plain version on the same SH."""
    dev = _card()
    lanes = 589_824
    args = _dead_tail(shade_case("pool", "volume", lanes, dev), live, 128, 3)
    rng = np.random.default_rng(8)
    per_lane = torch.from_numpy(rng.normal(scale=0.4, size=(lanes, 4, 3))
                                .astype(np.float32)).to(dev)
    _check_shade(dict(args, sh_sampler=lambda world_pos: per_lane[:world_pos.shape[0]]))


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", SAMPLERS)
@pytest.mark.parametrize("inline", [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("case", [("pool", "volume"), ("puff", "ambient"),
                                  ("slots", "lightmap")])
def test_shade_kernel_inline_flags_on_card(case, inline, sampler):
    _check_shade(shade_case(*case, 512, _card(), size=(1920, 1080), inline=inline,
                            sampler=sampler))


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", SAMPLERS)
@pytest.mark.parametrize("sh", ["ambient", "volume"])
def test_shade_kernel_64_layers_on_card(sh, sampler):
    """64 layers as a deep frame shades them: each layer's lanes (seeded
    sizes from 1 to 4,096) bit for bit, 64 or 128 launches in all."""
    dev = _card()
    base = shade_case("pool", sh, 4096, dev, size=(1920, 1080), sampler=sampler)
    rng = np.random.default_rng(11)
    before = port_particles.shade_particles.LAUNCHES
    for layer in range(64):
        n = int(rng.integers(1, 4097))
        pair = base["pair"][:n].clone()
        pair[rng.integers(0, n, size=max(1, n // 5))] = -1
        _check_shade(dict(base, pair=pair, px=base["px"][:n].clone(), py=base["py"][:n].clone()))
    assert port_particles.shade_particles.LAUNCHES - before == 64 * _shade_launches(base)


@pytest.mark.gpu
def test_shade_kernel_reads_unaligned_strided_rows_on_card():
    """Packed rows of a wider table at an odd offset (not 16-B aligned),
    lanes at a stride: the scalar row loads, bit for bit."""
    dev = _card()
    args = shade_case("slots-flat", "volume", 512, dev)
    packed = args["attrs"].packed
    wide = torch.zeros((packed.shape[0], 41), dtype=torch.float32, device=dev)
    wide[:, 1:33] = packed
    rows = wide[:, 1:33]
    assert rows.data_ptr() % 16 and rows.stride(0) == 41
    pair2 = torch.stack([args["pair"], args["pair"]], dim=1)[:, 0]
    args = dict(args, attrs=args["attrs"]._replace(packed=rows), pair=pair2)
    _check_shade(args)


@pytest.mark.gpu
@pytest.mark.parametrize("sh", ["ambient", "volume"])
def test_shade_kernel_in_a_cuda_graph_on_card(sh):
    """A call captured into a CUDA graph, replayed on new pairs written
    into the captured input: equal to the plain version on those pairs."""
    dev = _card()
    args = shade_case("pool", sh, 65_536, dev)
    pair = args["pair"].clone()
    port_particles.shade_particles(**dict(args, pair=pair))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rgb, alpha = port_particles.shade_particles(**dict(args, pair=pair))
    for seed in (1, 2):
        fresh = shade_case("pool", sh, 65_536, dev, seed=seed)
        pair.copy_(fresh["pair"])
        args["px"].copy_(fresh["px"])
        args["py"].copy_(fresh["py"])
        graph.replay()
        torch.cuda.synchronize()
        want_rgb, want_alpha = port_particles.shade_particles_plain(**dict(args, pair=pair))
        assert _bits_equal(rgb, want_rgb) and _bits_equal(alpha, want_alpha)


def _check_geometry(args: dict) -> None:
    before = port_particles.particle_geometry.LAUNCHES
    tri, attrs = port_particles.particle_geometry(**args)
    torch.cuda.synchronize()
    assert port_particles.particle_geometry.LAUNCHES - before == 1
    tri_p, attrs_p = port_particles.particle_geometry_plain(**args)
    for name in tri._fields:
        assert _bits_equal(getattr(tri, name), getattr(tri_p, name)), name
    for name in attrs._fields:
        assert _bits_equal(getattr(attrs, name), getattr(attrs_p, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("size", SIZES)
def test_geometry_kernel_equals_plain_on_card(size, flip):
    """The 64 particles' billboards, bit for bit: setup rows, boxes, valid,
    ids, num_valid, corner uvs and world positions, packed rows."""
    _check_geometry(geometry_args(size, _card(), flip))


@pytest.mark.gpu
@pytest.mark.parametrize("count", [1, 16, 40, 300, 1000])
def test_geometry_kernel_particle_counts_on_card(count):
    """1 particle, the all-passes 16, deep_k's 40, and more particles than
    the block has threads: each bit for bit."""
    dicts = (particle_dicts() * (count // 46 + 1))[:count]
    soa = pack_particles(dicts, cap=count)
    _check_geometry(geometry_args((1920, 1080), _card(), soa=soa))


@pytest.mark.gpu
def test_geometry_kernel_in_a_cuda_graph_on_card():
    """A capture replayed on new centres copied into its input."""
    dev = _card()
    args = geometry_args((1920, 1080), dev)
    port_particles.particle_geometry(**args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tri, attrs = port_particles.particle_geometry(**args)
    centre = args["particles"]["center"]
    for shift in (0.5, -1.25):
        centre.add_(shift)
        graph.replay()
        torch.cuda.synchronize()
        tri_p, attrs_p = port_particles.particle_geometry_plain(**args)
        assert all(_bits_equal(getattr(tri, n), getattr(tri_p, n)) for n in tri._fields)
        assert all(_bits_equal(getattr(attrs, n), getattr(attrs_p, n)) for n in attrs._fields)


def _three(x):
    x0, x1, x2 = x.unbind(-1)
    return {"(0+2)+1": ((x0 + x2) + x1) + 0.0, "(0+1)+2": ((x0 + x1) + x2) + 0.0}


@pytest.mark.gpu
def test_torch_orders_on_card():
    """The orders csrc/shade.cu's particle shade follows: torch.sum over a
    contiguous (n, 3) last dim (x0 + x2) + x1, torch.mean that times
    (float)(1 / 3), torch.sum over the corners of (n, 3, C) (x0 + x1) +
    x2, a zero sum +0; torch.linalg.cross fma(a1, b2, -(a2 b1))."""
    dev = _card()
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.normal(size=(100_000, 3)) * 10.0 ** rng.integers(
        -6, 7, size=(100_000, 3))).astype(np.float32)).to(dev)
    x[::17] = -0.0
    assert _bits_equal(torch.sum(x, dim=-1), _three(x)["(0+2)+1"])
    third = torch.tensor(float(np.float32(1.0 / 3.0)), device=dev)
    assert _bits_equal(torch.mean(x, dim=-1), _three(x)["(0+2)+1"] * third)
    c = x.reshape(-1, 3, 1).expand(-1, 3, 2).contiguous() * 1.5
    corners = torch.sum(c, dim=-2)
    assert _bits_equal(corners, _three(c.transpose(1, 2))["(0+1)+2"])
    a, b = x[:, None, :].expand(-1, 1, 3)[:, 0], torch.roll(x, 1, 0)
    got = torch.linalg.cross(a, b, dim=-1)
    A, B = a.double(), b.double()
    want = torch.stack([
        (A[:, i] * B[:, j] - (a[:, j] * b[:, i]).double()).float()
        for i, j in ((1, 2), (2, 0), (0, 1))], dim=-1)
    assert (got.view(torch.int32) != want.view(torch.int32)).float().mean() < 1e-5


# --- the particle pass in the small frames ---------------------------------------

@functools.lru_cache(maxsize=None)
def small_frame(name: str):
    """(tables, build(angle), state, fitted config, env) on the card of a small frame:
    the lit scene (LIT_PASSES_SMALL), the all-passes scene
    (ALL_PASSES_SMALL) and its deep_k form (40 more particles stacked along
    the view ray)."""
    from superconductor_tpu_torch import scenes
    from superconductor_tpu_torch.render.caps import fit_caps

    dev = _card()
    if name == "lit":
        tables, build, config, env = scenes.lit_passes_scene(device=dev, **LIT_PASSES_SMALL)
    else:
        tables, build, config, env = scenes.all_passes_scene(
            device=dev, deep_particles=40 if name == "deep_k" else 0, **scenes.ALL_PASSES_SMALL)
    state = build(0.3)
    return tables, build, state, fit_caps(tables, state, config, env), env


@pytest.mark.gpu
@pytest.mark.parametrize("frame", ["lit", "all_passes", "deep_k"])
def test_frame_particle_layers_on_card(frame, monkeypatch):
    """Every shade_particles call of an eager frame held against its plain
    version bit for bit, one launch a layer (the lit frame's SH sampled in
    the launch: the torch sampler runs in none of its shade calls, the
    opaque and blend shades' included)."""
    from superconductor_tpu_torch.render import frame as port_frame

    tables, _build, state, config, env = small_frame(frame)
    calls = []
    real = port_frame.shade_particles
    names = inspect.signature(real).parameters

    def record(*a, **k):
        calls.append(dict(zip(names, a), **k))
        return real(*a, **k)

    monkeypatch.setattr(port_frame, "shade_particles", record)
    before = port_particles.shade_particles.LAUNCHES
    sh_calls = sample_spherical_harmonics.CALLS
    port_frame.render_frame_impl(tables, state, config, env)
    torch.cuda.synchronize()
    layers = len(config.layer_caps(config.resolve_particle_layers()))
    assert len(calls) == layers
    assert port_particles.shade_particles.LAUNCHES - before == layers
    assert sample_spherical_harmonics.CALLS == sh_calls
    for k in calls:
        assert _shade_launches(k) == 1
        _check_shade(k)


@pytest.mark.gpu
def test_lit_frame_graph_equals_eager_and_plain_on_card():
    """The lit frame replayed from its CUDA graph equals its eager frame
    and its twin with the shade and particle shade plain versions (image
    and stats), at two poses."""
    from superconductor_tpu_torch.bench import plain_versions
    from superconductor_tpu_torch.render import frame as port_frame
    from superconductor_tpu_torch.render import frame_graph

    tables, build, _state, config, env = small_frame("lit")
    for angle in (0.3, 1.1):
        s = build(angle)
        assert frame_graph.captures(s, config)
        img, stats = port_frame.render_frame_stats(tables, s, config, env)
        eager, eager_stats = port_frame.render_frame_impl(tables, s, config, env, with_stats=True)
        saved = port_frame.shade_particles
        port_frame.shade_particles = port_particles.shade_particles_plain
        try:
            with plain_versions(("shade",)):
                twin, twin_stats = port_frame.render_frame_impl(tables, s, config, env,
                                                                with_stats=True)
        finally:
            port_frame.shade_particles = saved
        for other, other_stats in ((eager, eager_stats), (twin, twin_stats)):
            assert torch.equal(img, other)
            assert stats.keys() == other_stats.keys()
            assert all(torch.equal(stats[k], other_stats[k]) for k in stats)

"""The particle pass's plain versions against the JAX package, and its
kernels' wrappers on the CPU.

- shade_particles_plain against the JAX package's shade_particles on the
  same billboard rows and lanes (tests/test_torch_particles_card.py's
  cases: 64 particles, half of the ring's reading the emissive LUT, lanes
  inside the boxes, every 23rd dead), for the procedural puff, the smoke
  pool and the per-slot smoke maps, each with the constant ambient SH and
  with the light volume, at 256 x 128 and 1920 x 1080: alpha at rtol 1e-5
  / atol 1e-6, colour at rtol 1e-5 / atol 2e-6 with the ambient SH, as
  tests/test_torch_lines_particles.py states them (sqrt, rsqrt and the
  sRGB encode's pow differ by an ulp between torch and XLA), and with the
  light volume at tests/test_torch_lit.py's rtol 1e-4 / atol 2e-5
  (COLOUR_TOL says why);
- particle_geometry_plain against the JAX package's particle_geometry run
  eagerly, bit for bit, at both sizes and viewport flips;
- the wrappers run their plain versions on CPU tensors and raise on
  layouts their kernels do not take (meta tensors reach the checks);
- the constant-SH path's coefficients are sample_spherical_harmonics';
- render/frame.py's PARTICLE_PLAIN_VERSIONS names both wrappers, and the
  frame calls them by those names;
- the ctypes mirrors name the structs' fields.
"""

import ctypes
import dataclasses
import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_tpu.ops import particles as ref_particles
from superconductor_tpu.ops import shade as ref_shade
from superconductor_tpu_torch.ops import particles as port_particles
from superconductor_tpu_torch.ops import shade as port_shade
from superconductor_tpu_torch.render import frame as port_frame
from superconductor_tpu_torch.scenes import LIT_PASSES_SMALL, lit_passes_host
from test_torch_host import REF_HOST
from test_torch_particles_card import (
    SIZES,
    env_for,
    geometry_args,
    lanes_for,
    particle_soa,
    scene_for,
    sh_sampler,
    shade_case,
    uniforms_at,
)

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _ref_tables() -> dict:
    """The small lit scene's device_arrays(), built by the reference's host
    layer (equal bit for bit to scene_to_torch's, tests/test_torch_upload.py)."""
    return lit_passes_host(**LIT_PASSES_SMALL, host=REF_HOST)[0].device_arrays()


def _ref_scene(smoke: str) -> dict:
    d = dict(_ref_tables())
    if smoke.startswith("slots"):
        d.pop("smoke_ab")
        d.pop("smoke_lut")
    return d


# colour (rtol, atol) by SH source: tests/test_torch_lines_particles.py's
# with the ambient SH; tests/test_torch_lit.py's shaded colour (as
# tests/test_torch_shade.py's) with the light volume, whose channel lengths
# above 1 make the ambient term negative, so that directional * light_map +
# ambient cancels to 1e-5 at some lanes and an ulp of either term (their
# reductions' order, XLA's contracted lerps in the volume's sampler) is
# 4e-4 of the result there
COLOUR_TOL = {"ambient": (1e-5, 2e-6), "volume": (1e-4, 2e-5)}


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("sh", ["ambient", "volume"])
@pytest.mark.parametrize("smoke", ["puff", "pool", "slots"])
def test_shade_particles_plain_matches_reference(smoke, sh, size):
    """The torch chain against the JAX package's on the reference's
    billboard rows, its SH sampled by each package's sampler over the
    frame's stand-in g-buffer: colour within COLOUR_TOL, alpha at rtol 1e-5
    / atol 1e-6."""
    u_np = uniforms_at(*size)
    soa = particle_soa()
    mats = [jnp.asarray(u_np[k][0]) for k in ("view", "view_inverse", "projection")]
    soa_r = {k: jnp.asarray(v) for k, v in soa.items()}
    tri, attrs = ref_particles.particle_geometry(soa_r, *mats, *size)
    pair, px, py = lanes_for(np.asarray(tri.valid), np.asarray(tri.bbox), 2048, 9)
    env = env_for(smoke, sh)
    dev_r = _ref_scene(smoke)
    u_r = {k: jnp.asarray(v) for k, v in u_np.items()}

    def sh_ref(world_pos):
        n = world_pos.shape[0]
        stand_in = ref_shade.GBuffer(
            valid=None, world_pos=world_pos, normal=None, uv=None,
            lm_uv=jnp.zeros((n, 2), jnp.float32), material=None, front_facing=None,
            lightmapped=jnp.zeros(n, bool), dpdx=None, dpdy=None, duvdx=None, duvdy=None)
        return ref_shade.sample_spherical_harmonics(stand_in, dev_r, u_r, env)

    rgb_r, a_r = ref_particles.shade_particles(
        jnp.asarray(pair), jnp.asarray(px), jnp.asarray(py), tri, attrs, soa_r, dev_r, u_r, env,
        0, sh_ref)
    scene_p = scene_for(smoke, "cpu")
    u_p = {k: _t(v) for k, v in u_np.items()}
    attrs_p = port_particles.ParticleAttrs(*[None if x is None else _t(x) for x in attrs])
    tri_p = tri._replace(**{k: _t(getattr(tri, k)) for k in tri._fields})
    rgb_p, a_p = port_particles.shade_particles_plain(
        _t(pair), _t(px), _t(py), tri_p, attrs_p, {k: _t(v) for k, v in soa.items()}, scene_p,
        u_p, env, 0, sh_sampler(scene_p, u_p, env))
    rtol, atol = COLOUR_TOL[sh]
    np.testing.assert_allclose(rgb_p.numpy(), np.asarray(rgb_r), rtol=rtol, atol=atol)
    np.testing.assert_allclose(a_p.numpy(), np.asarray(a_r), rtol=1e-5, atol=1e-6)
    a = a_p.numpy()
    assert (a[pair >= 0] > 0).any() and (a[pair < 0] == 0).all()
    lut = np.asarray(attrs.packed)[np.maximum(pair, 0), 30] >= 0
    assert lut[pair >= 0].any() and (~lut[pair >= 0]).any()


def _assert_bits(a, b, name):
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, name
    assert np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                          np.ascontiguousarray(b).view(np.uint8)), name


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("size", SIZES)
def test_particle_geometry_plain_matches_reference(size, flip):
    """Every field of the billboards (setup rows, boxes, valid, ids,
    num_valid, corner uvs and world positions, packed rows) equals the
    eager reference's bit for bit, particles behind the eye, of zero scale
    and invalid included."""
    args = geometry_args(size, "cpu", flip)
    tri_r, attrs_r = ref_particles.particle_geometry(
        {k: jnp.asarray(v.numpy()) for k, v in args["particles"].items()},
        *[jnp.asarray(args[k].numpy()) for k in ("view", "view_inverse", "projection")],
        *size, flip_viewport=flip)
    tri_p, attrs_p = port_particles.particle_geometry_plain(**args)
    for name in tri_r._fields:
        _assert_bits(getattr(tri_r, name), getattr(tri_p, name), name)
    for name in attrs_r._fields:
        _assert_bits(getattr(attrs_r, name), getattr(attrs_p, name), name)
    v = tri_p.valid.numpy()
    assert 0 < v.sum() < v.shape[0]


@pytest.mark.parametrize("smoke", ["puff", "pool", "slots", "slots-flat"])
def test_wrappers_run_the_plain_versions_on_cpu(smoke):
    """On CPU tensors each wrapper returns its plain version's result and
    counts no launch."""
    launches = (port_particles.shade_particles.LAUNCHES,
                port_particles.particle_geometry.LAUNCHES)
    args = shade_case(smoke, "volume", 512, "cpu")
    got, want = port_particles.shade_particles(**args), \
        port_particles.shade_particles_plain(**args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    g = geometry_args((256, 128), "cpu")
    (tri, attrs), (tri_p, attrs_p) = port_particles.particle_geometry(**g), \
        port_particles.particle_geometry_plain(**g)
    assert all(torch.equal(getattr(tri, n), getattr(tri_p, n)) for n in tri._fields)
    assert all(torch.equal(getattr(attrs, n), getattr(attrs_p, n)) for n in attrs._fields)
    assert launches == (port_particles.shade_particles.LAUNCHES,
                        port_particles.particle_geometry.LAUNCHES)


def _meta(x):
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    if isinstance(x, dict):
        return {k: _meta(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_meta(v) for v in x])
    return x


def _meta_shade_args(smoke="pool", sh="ambient") -> dict:
    args = shade_case(smoke, sh, 64, "cpu")
    return {k: (v if k in ("sh_sampler", "env") else _meta(v)) for k, v in args.items()}


SHADE_FAULTS = {
    "pair int64": (lambda a: dict(a, pair=a["pair"].long()), "pair"),
    "pair (P, 1)": (lambda a: dict(a, pair=a["pair"][:, None]), "pair"),
    "px short": (lambda a: dict(a, px=a["px"][:-1]), "px"),
    "py float64": (lambda a: dict(a, py=a["py"].double()), "py"),
    "no packed rows": (lambda a: dict(a, attrs=a["attrs"]._replace(packed=None)), "packed"),
    "packed (T, 31)": (lambda a: dict(a, attrs=a["attrs"]._replace(
        packed=a["attrs"].packed[:, :31])), "attrs.packed"),
    "packed columns apart": (lambda a: dict(a, attrs=a["attrs"]._replace(
        packed=torch.empty((a["attrs"].packed.shape[0], 64), device="meta")[:, ::2])),
        "attrs.packed"),
    "packed float64": (lambda a: dict(a, attrs=a["attrs"]._replace(
        packed=a["attrs"].packed.double())), "attrs.packed"),
    "view out of range": (lambda a: dict(a, view_index=1), "view"),
    "smoke pool float32": (lambda a: dict(a, scene=dict(a["scene"], smoke_ab=a["scene"][
        "smoke_ab"].float())), "smoke_ab"),
    "smoke LUT rows of 12": (lambda a: dict(a, scene=dict(a["scene"], smoke_lut=a["scene"][
        "smoke_lut"][:, :12])), "smoke_lut"),
    "eye on another device": (lambda a: dict(a, uniforms=dict(a["uniforms"], eye=torch.zeros(
        (1, 3)))), "eye"),
    "ambient of 9": (lambda a: dict(a, env=dataclasses.replace(a["env"],
                                                              ambient_sh=(0.0,) * 9)), "ambient"),
}


@pytest.mark.parametrize("fault", sorted(SHADE_FAULTS))
def test_shade_wrapper_raises_on_what_the_kernel_does_not_take(fault):
    make, word = SHADE_FAULTS[fault]
    with pytest.raises((TypeError, ValueError), match=word):
        port_particles.shade_particles(**make(_meta_shade_args()))


def test_shade_wrapper_raises_on_the_per_slot_tables():
    args = _meta_shade_args("slots")
    tex = dict(args["scene"]["tex"], tex_meta=args["scene"]["tex"]["tex_meta"][:, :3])
    with pytest.raises(ValueError, match="tex_meta"):
        port_particles.shade_particles(**dict(args, scene=dict(args["scene"], tex=tex)))
    with pytest.raises(ValueError, match="LDR pool"):
        port_particles.shade_particles(**dict(args, scene=dict(
            args["scene"], texels_q=args["scene"]["texels_q"][:, :8])))


def test_shade_wrapper_reaches_the_launch_with_meta_tensors():
    """A layout the kernel takes passes every check and stops only at the
    device (meta, not CUDA)."""
    for smoke in ("puff", "pool", "slots", "slots-flat"):
        with pytest.raises(ValueError, match="CUDA tensors, not meta"):
            port_particles.shade_particles(**_meta_shade_args(smoke))


GEOMETRY_FAULTS = {
    "center float64": (lambda a: dict(a, particles=dict(a["particles"], center=a[
        "particles"]["center"].double())), "center"),
    "valid int32": (lambda a: dict(a, particles=dict(a["particles"], valid=a[
        "particles"]["valid"].int())), "valid"),
    "lut flags int64": (lambda a: dict(a, particles=dict(a["particles"], use_emissive_lut=a[
        "particles"]["use_emissive_lut"].long())), "use_emissive_lut"),
    "scale (P, 3)": (lambda a: dict(a, particles=dict(a["particles"], scale=torch.empty(
        (a["particles"]["scale"].shape[0], 3), device="meta"))), "scale"),
    "no lut_y": (lambda a: dict(a, particles={k: v for k, v in a["particles"].items()
                                              if k != "lut_y"}), "lut_y"),
    "colour rows apart": (lambda a: dict(a, particles=dict(a["particles"], colour=torch.empty(
        (a["particles"]["colour"].shape[0], 6), device="meta")[:, ::2])), "colour"),
    "view (3, 4)": (lambda a: dict(a, view=a["view"][:3]), "view"),
    "projection float64": (lambda a: dict(a, projection=a["projection"].double()),
                           "projection"),
    "zero width": (lambda a: dict(a, width=0), "target"),
}


@pytest.mark.parametrize("fault", sorted(GEOMETRY_FAULTS))
def test_geometry_wrapper_raises_on_what_the_kernel_does_not_take(fault):
    make, word = GEOMETRY_FAULTS[fault]
    args = _meta(geometry_args((256, 128), "cpu"))
    with pytest.raises((TypeError, ValueError), match=word):
        port_particles.particle_geometry(**make(args))
    with pytest.raises(ValueError, match="CUDA tensors, not meta"):
        port_particles.particle_geometry(**args)


@pytest.mark.parametrize("sh", ["ambient", "volume", "lightmap"])
def test_constant_sh_is_the_samplers(sh):
    """Where the environment binds no light volume and no lightmaps
    (_ambient_only), the 12 values the kernel takes are what
    sample_spherical_harmonics gives every lane, bit for bit; elsewhere the
    sampler gives others, and the wrapper samples."""
    args = shade_case("pool", sh, 512, "cpu")
    sampled = args["sh_sampler"](torch.randn(512, 3) * 4.0)
    constant = port_particles.ambient_values(args["env"]).reshape(4, 3).expand(512, 4, 3)
    assert port_shade._ambient_only(args["env"]) == (sh == "ambient")
    assert torch.equal(sampled.view(torch.int32), constant.view(torch.int32)) == (
        sh == "ambient")


def test_plain_versions_name_both_wrappers():
    """PARTICLE_PLAIN_VERSIONS binds each particle wrapper, where the frame
    looks it up, with its plain version."""
    table = port_frame.PARTICLE_PLAIN_VERSIONS
    assert sorted(table) == ["particle_geometry", "particle_shade"]
    for kernel, name, plain, wrapper in (
            ("particle_shade", "shade_particles", port_particles.shade_particles_plain,
             port_particles.shade_particles),
            ("particle_geometry", "particle_geometry", port_particles.particle_geometry_plain,
             port_particles.particle_geometry)):
        (mod, bound, bound_plain), = table[kernel]
        assert mod is port_frame and bound == name and bound_plain is plain
        assert getattr(port_frame, name) is wrapper


def test_frame_calls_the_wrappers_by_their_frame_names(monkeypatch):
    """One all-passes frame at 256 x 128 on the CPU calls particle_geometry
    once (one view) and shade_particles once a particle layer, through the
    names PARTICLE_PLAIN_VERSIONS binds; with the plain versions bound
    there it renders the same frame."""
    from superconductor_tpu_torch.render.caps import fit_caps
    from superconductor_tpu_torch.render.frame import render_frame
    from superconductor_tpu_torch.scenes import ALL_PASSES_SMALL, all_passes_scene

    dev, build, config, env = all_passes_scene(device="cpu", **ALL_PASSES_SMALL)
    state = build(0.3)
    config = fit_caps(dev, state, config, env)
    calls = []
    for (mod, name, _plain), in port_frame.PARTICLE_PLAIN_VERSIONS.values():
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real, **k: (
            calls.append(_n), _r(*a, **k))[1])
    img = render_frame(dev, state, config, env)
    assert calls.count("particle_geometry") == 1
    assert calls.count("shade_particles") == len(config.layer_caps(
        config.resolve_particle_layers()))
    monkeypatch.undo()
    for (mod, name, plain), in port_frame.PARTICLE_PLAIN_VERSIONS.values():
        monkeypatch.setattr(mod, name, plain)
    assert torch.equal(render_frame(dev, state, config, env), img)


def _cu_fields(source: str, struct: str) -> list:
    path = os.path.join(os.path.dirname(port_particles.__file__), os.pardir, "csrc", source)
    with open(path) as f:
        src = f.read()
    body = re.search(r"struct " + struct + r" \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in body.split(";")[:-1]:
        m = re.search(r"(\w+)(?:\[(\w+)\])?\s*$", decl.strip())
        out.append((m.group(1), m.group(2) or 1))
    return out


@pytest.mark.parametrize("mirror, source, struct", [
    ("_ShadeArgs", "shade.cu", "ParticleShadeArgs"),
    ("_QuadArgs", "geometry.cu", "ParticleQuadArgs")])
def test_mirrors_name_the_structs_fields(mirror, source, struct):
    """Each ctypes mirror names its struct's fields in order, each 8 B but
    the 12 ambient floats; on the card the sizes themselves are compared
    before the first launch (ops/particles.py _entry)."""
    m = getattr(port_particles, mirror)
    cu = _cu_fields(source, struct)
    assert [f for f, _ in m._fields_] == [f for f, _ in cu]
    for (name, ctype), (_, length) in zip(m._fields_, cu):
        if length == 1:
            assert ctypes.sizeof(ctype) == 8, name
        else:
            assert name == "ambient" and length == "12" and ctype._length_ == 12


# --- chip_smoke.py's [particles] helpers and profile_frame's labels ---------------

def test_chip_smoke_particle_bound_counts_the_calls_bytes():
    """The billboards' bound: 69 B of columns read and 554 B of results
    written a particle, the three matrices and num_valid; a layer's shade:
    28 B a lane, 48 B more with sampled SH, 128 B a distinct packed row,
    the eye and the inverse view; each over 3.35 TB/s, bytes above the
    operations at 67 TFLOP/s."""
    import chip_smoke

    g = geometry_args((256, 128), "cpu")
    ms, by = chip_smoke.particle_bound("particle_geometry", g, [])
    assert by == "bytes" and ms == pytest.approx((64 * (69 + 554) + 3 * 64 + 4) / 3.35e9)
    for sh, extra in (("ambient", 0), ("volume", 48)):
        args = shade_case("pool", sh, 512, "cpu")
        rows = int(torch.unique(torch.clamp_min(args["pair"], 0)).numel())
        ms, by = chip_smoke.particle_bound("shade_particles", args, [])
        assert by == "bytes"
        assert ms == pytest.approx((512 * (28 + extra) + rows * 128 + 76) / 3.35e9)
        assert chip_smoke.particle_launches("shade_particles", args) == (1 if sh == "ambient"
                                                                         else 2)
        assert chip_smoke.particle_site("shade_particles", "layer", args) == (
            f"shade_particles layer 512 lanes (smoke pool; "
            f"{'ambient SH' if sh == 'ambient' else 'sampled SH, 2 launches'}; tonemap 1 srgb 1)")
    for smoke, branch in (("puff", "puff"), ("slots", "per-slot"), ("slots-flat", "per-slot")):
        assert chip_smoke.particle_smoke(shade_case(smoke, "ambient", 1, "cpu")) == branch


def test_chip_smoke_particle_equal_compares_every_field_by_bits():
    import chip_smoke

    g = geometry_args((256, 128), "cpu")
    out = port_particles.particle_geometry_plain(**g)
    assert chip_smoke.particle_equal(out, out, g)[0]
    moved = (out[0]._replace(setup=out[0].setup.clone()), out[1])
    moved[0].setup[3, 2] = torch.nextafter(moved[0].setup[3, 2], torch.tensor(1e9))
    ok, total, bad = chip_smoke.particle_equal(moved, out, g)
    assert not ok and bad == 1 and total == sum(t.numel() for t in chip_smoke._leaves(out))


def test_profile_frame_tells_the_overloads_apart():
    """The particle kernels share the shade and view setup kernels' names;
    the device event's argument type tells them apart."""
    from superconductor_tpu_torch.profile_frame import hand_kernel_label

    ns = "(anonymous namespace)::"
    assert hand_kernel_label(f"{ns}shade_kernel({ns}ShadeArgs)") == "shade_kernel"
    assert hand_kernel_label(f"{ns}shade_kernel({ns}ParticleShadeArgs)") == \
        "shade_kernel(ParticleShadeArgs)"
    assert hand_kernel_label(f"void {ns}view_setup_kernel({ns}SetupArgs)") == \
        "view_setup_kernel"
    assert hand_kernel_label(f"void {ns}view_setup_kernel(const {ns}ParticleQuadArgs)") == \
        "view_setup_kernel(ParticleQuadArgs)"
    assert hand_kernel_label(f"void {ns}vertex_stage_kernel<1>({ns}VertexArgs)") == \
        "vertex_stage_kernel"
    assert hand_kernel_label("void at::native::vectorized_elementwise_kernel<4>") is None

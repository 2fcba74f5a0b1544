"""The clip_blend slice end to end (BASELINE config 3: the helmet plus the
all-passes sphere ring with alpha-clipped and alpha-blended spheres): the
256x128 frame through the port against the reference's
render_frame_stats (raster="pallas", its Pallas kernels in interpret mode
on the CPU) with the same config; the golden frame chip_smoke.py holds the
card against; and albedo_alpha, the alpha-clip test, against the
reference's on the same g-buffer.

The frame is scenes.CLIP_BLEND_SMALL: 256x128, spheres cut from 88 to 32
stacks and slices for CPU speed (chip_smoke.py renders its 256x128 check
from the same settings)."""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_tpu.ops import shade as ref_shade
from superconductor_tpu.render import frame as ref_frame
from superconductor_tpu.render.draws import build_frame_state as ref_build
from superconductor_tpu.utils.metrics import psnr
from superconductor_tpu_torch.math3d import Similarity
from superconductor_tpu_torch.ops import shade as port_shade
from superconductor_tpu_torch.ops import tonemap as port_tonemap
from superconductor_tpu_torch.render import frame as port_frame
from superconductor_tpu_torch.render.draws import build_frame_state as port_build
from superconductor_tpu_torch.scene.upload import scene_to_torch
from superconductor_tpu_torch.scenes import CLIP_BLEND_SMALL, clip_blend_host, headline_host
from test_torch_host import REF_HOST

# The test workers share the CPU: torch's default of a thread per core in
# each of them oversubscribes it many times over.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "torch_clip_blend_256x128.npz")
ANGLE = 0.3  # sphere turn of the golden frame


@functools.lru_cache(maxsize=None)
def _host():
    """The scene built by the port's host layer."""
    return clip_blend_host(**CLIP_BLEND_SMALL)


@functools.lru_cache(maxsize=None)
def _ref_host():
    """The same scene built by the reference's host layer."""
    return clip_blend_host(**CLIP_BLEND_SMALL, host=REF_HOST)


@functools.lru_cache(maxsize=None)
def _tables():
    return _ref_host()[0].device_arrays(), scene_to_torch(_host()[0], "cpu")


def _ref_config(config):
    return ref_frame.RenderConfig(**{**dataclasses.asdict(config), "raster": "pallas"})


# the scene's config as it comes, and one whose every transparent
# worklist is a per-layer compacted one below the pixel count
CONFIGS = {
    "as-built": {},
    "per-layer-worklists": dict(
        opaque_px_cap=1 << 14, shade_px_cap=1 << 13, clip_layers=2, blend_layers=2,
        shade_px_caps=(1 << 13, 1 << 11), clip_px_caps=(1 << 13, 1 << 12),
    ),
}

_REFERENCE_CHILD = textwrap.dedent(
    """
    import dataclasses, json, sys
    import numpy as np
    from superconductor_tpu.render import frame as ref_frame
    from superconductor_tpu.render.draws import build_frame_state
    from superconductor_tpu_torch.scenes import CLIP_BLEND_SMALL, clip_blend_host
    sys.path.insert(0, "tests")
    from test_torch_host import REF_HOST

    configs, angle = json.loads(sys.argv[2]), float(sys.argv[3])
    scene, instances, uniforms, env, config = clip_blend_host(**CLIP_BLEND_SMALL, host=REF_HOST)
    dev = scene.device_arrays()
    state = build_frame_state(scene, instances(angle), uniforms)
    out, stats = {}, {}
    for name, change in configs.items():
        change = {k: tuple(v) if isinstance(v, list) else v for k, v in change.items()}
        rcfg = ref_frame.RenderConfig(**{**dataclasses.asdict(config), **change,
                                         "raster": "pallas"})
        img, st = ref_frame.render_frame_stats(dev, state, rcfg, env)
        out[name] = np.asarray(img)
        stats[name] = ref_frame.stats_to_host(st)
    np.savez(sys.argv[1], stats=json.dumps(stats), **out)
    """
)


@pytest.fixture(scope="module")
def reference():
    """variant -> (image, stats) of the reference's render_frame_stats,
    rendered in ONE child process whose XLA CPU backend is capped at AVX:
    with FMA instructions the jitted reference contracts the multiply-adds
    of its setup rows, and a bounding box that moves by a pixel changes
    pairs_needed (measured 5259 against 5253). Without them it rounds op by
    op, as the port does."""
    with tempfile.TemporaryDirectory() as tmp:
        dst = os.path.join(tmp, "reference.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
        env.pop("PYTHONPATH", None)
        out = subprocess.run(
            [sys.executable, "-c", _REFERENCE_CHILD, dst, json.dumps(CONFIGS), str(ANGLE)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
        )
        assert out.returncode == 0, out.stdout + out.stderr
        ref = np.load(dst)
        stats = json.loads(str(ref["stats"]))
        return {name: (ref[name], stats[name]) for name in CONFIGS}


def _port_frame(config):
    scene, instances, uniforms, env, _ = _host()
    return port_frame.render_frame_stats(
        _tables()[1], port_build(scene, instances(ANGLE), uniforms, device="cpu"), config, env
    )


@pytest.mark.parametrize("variant", sorted(CONFIGS))
def test_clip_blend_frame_matches_reference(reference, variant):
    """Image PSNR >= 40 dB (the goldens bar, tests/test_goldens.py:48) and
    the stats dict equal key for key, with both passes really engaged: a
    clipped surface two layers deep and a blended one."""
    img_r, stats_r = reference[variant]
    img_p, stats_p = _port_frame(dataclasses.replace(_host()[4], **CONFIGS[variant]))
    stats_p = port_frame.stats_to_host(stats_p)
    assert img_p.dtype == torch.uint8 and tuple(img_p.shape) == img_r.shape == (1, 128, 256, 4)
    db = psnr(img_r, img_p.numpy())
    assert db >= 40.0, db
    assert stats_r == stats_p
    assert stats_p["clip_layers_needed"] >= 2 and stats_p["blend_layers_needed"] >= 1
    assert stats_p["clip_px_needed_k"][1] > 0 and stats_p["shade_px_needed_k"][0] > 0


def test_clip_blend_golden_is_the_reference_frame(reference):
    """tests/goldens/torch_clip_blend_256x128.npz holds the reference's
    clip_blend frame at 256x128 (spheres at 0.3 rad, the scene's config,
    raster="pallas"): chip_smoke.py holds the card's frame against it,
    where jax is not imported. The reference must still render it (PSNR >=
    40 dB, the goldens bar), and so must the port on the CPU. Regenerate
    with SC_REGEN_GOLDENS=1."""
    img_r = reference["as-built"][0]
    if os.environ.get("SC_REGEN_GOLDENS"):
        np.savez_compressed(GOLDEN, image=img_r)
    golden = np.load(GOLDEN)["image"]
    assert golden.shape == (1, 128, 256, 4) and golden.dtype == np.uint8
    assert psnr(golden, img_r) >= 40.0
    scene, instances, uniforms, env, config = _host()
    img_p = port_frame.render_frame(
        _tables()[1], port_build(scene, instances(ANGLE), uniforms, device="cpu"), config, env
    )
    assert psnr(golden, img_p.numpy()) >= 40.0


def test_clip_resolve_sees_through_failing_layers():
    """The port's frame with the clip pass against the same frame without
    it: they differ on some clip-covered pixels (a passing clip layer
    replaces the opaque winner or sky) and not on others (every clip layer
    there fails, so the opaque result or the sky stays)."""
    scene, instances, uniforms, env, config = _host()
    img, stats = _port_frame(config)
    no_clip = port_frame.render_frame(
        _tables()[1], port_build(scene, instances(ANGLE), uniforms, device="cpu"),
        dataclasses.replace(config, enable_clip=False), env,
    )
    differs = int((img != no_clip).any(dim=-1).sum())
    assert 0 < differs < port_frame.stats_to_host(stats)["clip_px_needed_k"][0]


@functools.lru_cache(maxsize=None)
def _gbuffer():
    """The reference's g-buffer of lanes on every triangle of the scene
    (pixel centres at bbox centres, jittered; numpy seed), from its jitted
    geometry: inputs, fed to both sides."""
    scene, instances, uniforms, _env, config = _ref_host()
    dev_r, _ = _tables()
    rcfg = _ref_config(config)
    state = ref_build(scene, instances(ANGLE), uniforms)
    tri, attrs = jax.jit(
        lambda dev, state: ref_frame._merged_geometry(
            dev, state, state.uniforms["view_proj"][0], rcfg
        )
    )(dev_r, state)
    shade_row = jnp.concatenate(
        [tri.setup, attrs.packed, dev_r["materials"]["mat_row_mq"][attrs.material]], axis=1
    )
    valid = np.where(np.asarray(tri.valid))[0]
    rng = np.random.default_rng(31)
    p = 4096
    pair = rng.choice(valid, size=p).astype(np.int32)
    pair[::19] = -1
    bbox = np.asarray(tri.bbox)[np.maximum(pair, 0)]
    px = ((bbox[:, 0] + bbox[:, 2]) // 2 + rng.integers(-2, 3, size=p)).astype(np.float32) + 0.5
    py = ((bbox[:, 1] + bbox[:, 3]) // 2 + rng.integers(-2, 3, size=p)).astype(np.float32) + 0.5
    return ref_shade.interpolate_gbuffer(
        jnp.asarray(pair), jnp.asarray(px), jnp.asarray(py), tri, attrs, shade_row=shade_row
    )


@pytest.mark.parametrize("taps", [1, 4])
def test_albedo_alpha_matches_reference(taps):
    """Albedo alpha and cutoff on the reference's g-buffer of the helmet
    and the spheres: alpha at rtol 1e-5 / atol 1e-6 (the texel decode and
    filtering are the shade tests' functions, tests/test_torch_shade.py),
    the cutoff bit for bit; the clipped spheres' lanes hold both passing
    and failing alpha."""
    g = _gbuffer()
    dev_r, dev_p = _tables()
    a_r, c_r = ref_shade.albedo_alpha(g, dev_r, aniso_taps=taps)
    gp = port_shade.GBuffer(*[None if x is None else torch.from_numpy(np.array(x)) for x in g])
    a_p, c_p = port_shade.albedo_alpha(gp, dev_p, aniso_taps=taps)
    np.testing.assert_allclose(a_p.numpy(), np.asarray(a_r), rtol=1e-5, atol=1e-6)
    assert np.array_equal(c_p.numpy(), np.asarray(c_r))
    blend_mode = np.asarray(dev_r["materials"]["blend_mode"])[np.asarray(g.material)]
    clip = np.asarray(g.valid) & (blend_mode == 1)
    a = a_p.numpy()[clip]
    assert (a < 0.5).any() and (a >= 0.5).any()


def test_albedo_alpha_outside_the_slice_raises():
    """albedo_alpha on the wide mq3 rows (Scene.matq3x3) equals it on the
    64 B rows bit for bit: both sample every level exactly (the
    reference's tests/test_matq.py:154). The classic samplers give the
    interleaved path's alpha here (the scene's pool is whole) to 2e-6
    abs: the classic per-slot lerp and the interleaved row's differ in
    association only (the reference's tests/test_matq.py:377 holds the
    same)."""
    g = port_shade.GBuffer(*[None if x is None else torch.from_numpy(np.array(x))
                             for x in _gbuffer()])
    _, dev_p = _tables()
    scene = clip_blend_host(**CLIP_BLEND_SMALL)[0]
    scene.matq3x3 = True
    wide = scene_to_torch(scene, "cpu")
    assert wide["texels_mq"].shape[-1] == 208
    a, cutoff = port_shade.albedo_alpha(g, dev_p)
    a_w, cutoff_w = port_shade.albedo_alpha(g, wide)
    assert torch.equal(a_w, a) and torch.equal(cutoff_w, cutoff)
    classic = {k: v for k, v in dev_p.items() if k != "texels_mq"}
    a_c, cutoff_c = port_shade.albedo_alpha(g, classic)
    np.testing.assert_allclose(a_c.numpy(), a.numpy(), rtol=0, atol=2e-6)
    assert torch.equal(cutoff_c, cutoff)


def test_headline_scene_unchanged_by_clip_and_blend():
    """The headline holds no clipped or blended material: turning both
    passes on changes neither its image nor any stat but the pass flags'
    own (all zero)."""
    scene, model, uniforms, env, config = headline_host(128, 64)
    state = port_build(scene, [(model, Similarity())], uniforms, device="cpu")
    dev = scene_to_torch(scene, "cpu")
    off = port_frame.render_frame_stats(dev, state, config, env)
    on = port_frame.render_frame_stats(
        dev, state, dataclasses.replace(config, enable_clip=True, enable_blend=True), env
    )
    assert torch.equal(off[0], on[0])
    assert port_frame.stats_to_host(off[1]) == port_frame.stats_to_host(on[1])


def test_one_ulp_in_the_encode_is_the_card_cpu_gap(monkeypatch):
    """The card's 256x128 frame is 96.30 dB from the CPU's: two u8 values
    one step apart, stats equal. chip_smoke.py traces both renders; the
    setup rows, bins, raster and k-buffer planes, worklists and the live
    g-buffer lanes are equal, and the first result that differs is
    albedo_alpha (24 of 2,169 lanes, 1.8e-7), then the sky, the shaded rows
    and the encode. On the card torch's pow, log2, sqrt and rsqrt round an
    ulp or two apart from the CPU's on 1-31% of values (division and
    products do not): the sRGB decode and encode, the texture LOD and the
    normalisations. An ulp in an encoded value moves its u8 only where the
    value lies within an ulp of a rounding boundary. Shown here with the
    encode's result one ulp up at every value on the CPU: three u8 values
    move by one step (94.53 dB), the rest of the frame and the stats do
    not."""
    config = _host()[4]
    img, stats = _port_frame(config)
    real = port_tonemap.linear_to_srgb_approx

    def one_ulp_up(x):
        y = real(x)
        return torch.nextafter(y, torch.full_like(y, 2.0))

    monkeypatch.setattr(port_tonemap, "linear_to_srgb_approx", one_ulp_up)
    monkeypatch.setattr(port_shade, "linear_to_srgb_approx", one_ulp_up)
    img_u, stats_u = _port_frame(config)
    diff = np.abs(img.numpy().astype(int) - img_u.numpy().astype(int))
    assert diff.max() == 1 and 0 < int((diff > 0).sum()) <= 16
    assert psnr(img.numpy(), img_u.numpy()) >= 90.0
    assert port_frame.stats_to_host(stats) == port_frame.stats_to_host(stats_u)

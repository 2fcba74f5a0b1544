"""The deferred shade's wrapper on the CPU (ops/shade.py shade, the
wrapper of csrc/shade.cu, which takes its plain version shade_plain for
CPU tensors; tests/test_torch_deferred_card.py holds the kernel to it on
the card), against the JAX package's shade on every path:
tests/test_torch_deferred_card.py SHADE_CASES (the interleaved pool with
the material rows in the g-buffer's mat_tail and by material id, unlit
materials, the classic samplers, the material-path partition's s16, the
light volume's and the lightmaps' per-lane SH) under each of the four
inline_tonemapping x inline_srgb, on the same seeded lanes and the same
scenes, each built by its own package's host layer.

Tolerances as tests/test_torch_shade.py states them: the shaded colour at
rtol 1e-4 / atol 2e-5 (the math library's pow, log2 and rsqrt differ
between XLA's CPU kernels and torch's by an ulp, and the chain carries
them through the tonemap; well under one u8 step), alpha at rtol 1e-5 /
atol 1e-6. On the CPU shade and shade_plain agree bit for bit.

Also: the frame calls shade by the name render/frame.py binds (rebinding
it changes frame_graph's key), bench.plain_versions swaps it, a CPU call
counts no launch, and off the CPU shade_lanes raises on any input the
kernel does not take, and on any device but CUDA.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_tpu.ops import shade as ref_shade
from superconductor_tpu.render import frame as ref_frame
from superconductor_tpu_torch import bench, profile_frame
from superconductor_tpu_torch.ops import shade as port_shade
from superconductor_tpu_torch.render import frame as port_frame
from superconductor_tpu_torch.render import frame_graph
from superconductor_tpu_torch.scenes import (
    ALL_PASSES_SMALL,
    LIT_PASSES_SMALL,
    all_passes_host,
    headline_host,
    lit_passes_host,
)
from test_torch_deferred_card import (
    SHADE_CASES,
    SHADE_INLINE,
    shade_args,
    shade_env,
    shade_host,
    shade_lanes_np,
    with_unlit,
)
from test_torch_host import REF_HOST

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _reference(scene: str):
    """(device tables, EnvBindings) of a case's scene built by the JAX
    package's host layer."""
    if scene == "hero":
        host, _m, _u, env, _c = headline_host(256, 128, host=REF_HOST)
    elif scene == "all_passes":
        host, _i, _u, env, _c, _d = all_passes_host(**ALL_PASSES_SMALL, host=REF_HOST)
    else:
        host, _i, _u, env, _c, _d = lit_passes_host(**LIT_PASSES_SMALL, host=REF_HOST)
    return host.device_arrays(), env


def _flag_even_np(a: np.ndarray) -> np.ndarray:
    a.view(np.int32)[::2, 16] |= port_shade.MAT_UNLIT
    return a


def _reference_shade(case: str, inline) -> tuple:
    """The JAX package's shade on the case's lanes and its own tables."""
    scene, path, _sh = SHADE_CASES[case]
    tables, env = _reference(scene)
    _host, u, _env = shade_host(scene)
    mats = tables["materials"]
    if path == "unlit":
        tables = dict(tables, materials=with_unlit(
            mats, lambda a: jnp.asarray(_flag_even_np(a)), lambda t: np.array(t)))
    g = shade_lanes_np(case, mats["mat_row"].shape[0], u)
    if path == "tail":
        g["mat_tail"] = mats["mat_row_mq"][jnp.asarray(g["material"])]
    gbuf = ref_shade.GBuffer(**{k: jnp.asarray(v) for k, v in g.items()})
    s16 = None
    if path == "partition":
        need = int(((~np.asarray(tables["matq_capable"])[g["material"]]) & g["valid"]).sum())
        s16, _n = ref_frame._partition_material_sample(
            gbuf, tables, ref_frame.RenderConfig(matq_classic_cap=need + 64), 1)
    rgb, alpha = ref_shade.shade(gbuf, tables, {k: jnp.asarray(v) for k, v in u.items()}, 0,
                                 env=shade_env(case, env), inline_tonemapping=inline[0],
                                 inline_srgb=inline[1], s16=s16)
    return np.asarray(rgb), np.asarray(alpha)


@pytest.mark.parametrize("inline", SHADE_INLINE, ids=lambda f: f"tm{int(f[0])}-srgb{int(f[1])}")
@pytest.mark.parametrize("case", sorted(SHADE_CASES))
def test_shade_matches_reference_on_every_path(case, inline):
    """shade and shade_plain bit for bit on the CPU, and both against the
    JAX package's shade at the module's tolerances."""
    args = shade_args(case, "cpu", inline)
    before = port_shade.shade.LAUNCHES
    rgb, alpha = port_shade.shade(**args)
    plain_rgb, plain_alpha = port_shade.shade_plain(**args)
    assert port_shade.shade.LAUNCHES == before
    assert torch.equal(rgb.view(torch.int32), plain_rgb.view(torch.int32))
    assert torch.equal(alpha.view(torch.int32), plain_alpha.view(torch.int32))
    ref_rgb, ref_alpha = _reference_shade(case, inline)
    rgb, alpha = rgb.numpy(), alpha.numpy()
    assert rgb.shape == ref_rgb.shape and np.isfinite(rgb).all()
    np.testing.assert_allclose(rgb, ref_rgb, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(alpha, ref_alpha, rtol=1e-5, atol=1e-6)
    valid = args["gbuf"].valid.numpy()
    assert (rgb[~valid] == 0).all() and (alpha[~valid] == 0).all()
    assert (rgb[valid] > 0).any()
    if SHADE_CASES[case][1] == "unlit":  # the even materials' lanes show their albedo
        unlit = valid & (args["gbuf"].material.numpy() % 2 == 0)
        s16, _rows, _mat = port_shade._material_inputs(args["gbuf"], args["scene"], 1, None)
        pf = args["scene"]["materials"]["mat_row_mq"][args["gbuf"].material.long(), :3]
        albedo = (s16[:, :3] * pf).numpy()[unlit]
        want = np.clip(albedo, 0, 1) ** np.float32(1 / 2.2) if inline[1] else albedo
        np.testing.assert_allclose(rgb[unlit], want, rtol=1e-5, atol=1e-6)


def test_shade_is_the_frames_and_the_plain_twins():
    """render/frame.py calls ops/shade.py's shade by that name; rebinding
    it changes frame_graph's key; bench.plain_versions puts shade_plain
    there and the wrapper back after; profile_frame counts the kernel as a
    hand kernel."""
    assert port_frame.shade is port_shade.shade
    assert (port_frame, "shade") in frame_graph.KERNEL_NAMES
    scene, state = {"t": torch.zeros(3)}, (torch.zeros(2),)
    key = frame_graph.frame_key(scene, state, None, None, False)[0]
    with bench.plain_versions(("shade",)):
        assert port_frame.shade is port_shade.shade_plain
        assert frame_graph.frame_key(scene, state, None, None, False)[0] != key
        assert not frame_graph.frame_bindings_intact()
    assert port_frame.shade is port_shade.shade
    assert frame_graph.frame_bindings_intact()
    assert frame_graph.frame_key(scene, state, None, None, False)[0] == key
    assert profile_frame.HAND_KERNEL.search(
        "(anonymous namespace)::shade_kernel((anonymous namespace)::ShadeArgs)")


def _meta(x):
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_meta(v) for v in x])
    if isinstance(x, dict):
        return {k: _meta(v) for k, v in x.items()}
    if isinstance(x, port_shade.PoolSH):  # the SH pools and the probe box, as the lanes
        return port_shade.PoolSH(_meta(x.scene), _meta(x.uniforms), x.env)
    return x


@functools.lru_cache(maxsize=None)
def _lanes_args():
    """shade_lanes' arguments of the "by-id" case (the whole pool sampled
    on the CPU), and of the "volume" case (per-lane SH, classic rows)."""
    return {case: port_shade.shade_inputs(**shade_args(case, "cpu"))
            for case in ("by-id", "volume")}


def _gbuf(a, **fields):
    return dict(a, gbuf=a["gbuf"]._replace(**fields))


LANES_FAULTS = {
    "valid-dtype": lambda a: _gbuf(a, valid=a["gbuf"].valid.int()),
    "front_facing-shape": lambda a: _gbuf(a, front_facing=a["gbuf"].front_facing[:-1]),
    "normal-width": lambda a: _gbuf(a, normal=a["gbuf"].normal[:, :2]),
    "world_pos-dtype": lambda a: _gbuf(a, world_pos=a["gbuf"].world_pos.double()),
    "dpdy-columns-strided": lambda a: _gbuf(a, dpdy=a["gbuf"].dpdy.t().contiguous().t()),
    "duvdx-cpu": lambda a: _gbuf(a, duvdx=torch.zeros(a["gbuf"].duvdx.shape)),
    "s16-width": lambda a: dict(a, s16=a["s16"][:, :12]),
    "s16-dtype": lambda a: dict(a, s16=a["s16"].half()),
    "rows-narrow": lambda a: dict(a, rows=a["rows"][:, :17]),
    "rows-dtype": lambda a: dict(a, rows=a["rows"].double()),
    "rows-empty": lambda a: dict(a, rows=a["rows"][:0]),
    "rows-cpu": lambda a: dict(a, rows=torch.zeros(a["rows"].shape)),
    "mat-dtype": lambda a: dict(a, mat=a["mat"].long()),
    "mat-shape": lambda a: dict(a, mat=a["mat"][:-1]),
    "a-row-a-lane-count": lambda a: dict(a, mat=None),
    "sh-shape": lambda a: dict(a, sh=torch.zeros((a["s16"].shape[0], 3, 4), device="meta")),
    "sh-strided": lambda a: dict(a, sh=torch.zeros((a["s16"].shape[0], 3, 4), device="meta")
                                 .transpose(1, 2)),
    "ambient-count": lambda a: dict(a, ambient_sh=(0.0,) * 9),
    "eye-shape": lambda a: dict(a, eye=torch.zeros((4,), device="meta")),
    "eye-dtype": lambda a: dict(a, eye=a["eye"].double()),
}


@pytest.mark.parametrize("fault", sorted(LANES_FAULTS) + ["none", "none-sh", "none-a-row-a-lane"])
def test_shade_wrapper_raises_off_the_cpu(fault):
    """Meta tensors stand in for a card's: every input the kernel does not
    take raises, and a good one raises too, off CUDA (no plain path)."""
    lanes = _lanes_args()
    base = lanes["volume" if fault.endswith("sh") or fault.startswith("sh") else "by-id"]
    args = {k: _meta(v) for k, v in base.items()}
    if fault == "none-a-row-a-lane":
        args = dict(args, rows=_meta(base["rows"][base["mat"].long()]), mat=None)
    elif fault in LANES_FAULTS:
        args = LANES_FAULTS[fault](args)
    with pytest.raises((ValueError, TypeError),
                       match="CUDA tensors" if fault.startswith("none") else None):
        port_shade.shade_lanes(**args)


def test_shade_needs_env_off_the_cpu():
    """shade on meta tensors: without EnvBindings it raises as the plain
    version does; with a pre-sampled s16 and the ambient SH it reaches the
    kernel's wrapper, which refuses any device but CUDA."""
    args = shade_args("partition", "cpu")
    meta = dict(args, gbuf=_meta(args["gbuf"]), s16=_meta(args["s16"]),
                uniforms={k: _meta(v) for k, v in args["uniforms"].items()},
                scene=dict(args["scene"], materials={
                    k: _meta(v) for k, v in args["scene"]["materials"].items()}))
    with pytest.raises(ValueError, match="EnvBindings"):
        port_shade.shade(**dict(meta, env=None))
    with pytest.raises(ValueError, match="EnvBindings"):
        port_shade.shade_plain(**dict(args, env=None))
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_shade.shade(**meta)

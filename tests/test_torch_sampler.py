"""The material samplers of the port against the JAX package, on the CPU:
ops/sample.py sample_classic and sample_material (the wrappers of
csrc/sample.cu's kernels, which take their plain versions for CPU
tensors) on the seeded cases of tests/test_torch_sampler_card.py, against
the JAX package's classic path (superconductor_tpu/ops/shade.py
_material_rows, then ops/texture.py sample_anisotropic a slot) and its
sample_material_interleaved on the same numpy arrays. Tolerance rtol 1e-5 /
atol 1e-6, as tests/test_torch_shade.py holds every sampler: XLA's and
torch's CPU log2 and pow differ by an ulp, which moves the trilinear
fraction and the sRGB decode by about as much.

Also: the frame reaches both wrappers through their module (a swap takes
at every call site), rebinding either changes frame_graph's key and sends
the frame eager, and off the CPU a wrapper raises on any layout its kernel
does not take, and on any device but CUDA, rather than run a plain path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_tpu.ops import shade as ref_shade
from superconductor_tpu.ops import texture as ref_texture
from superconductor_tpu_torch.ops import sample as port_sample
from superconductor_tpu_torch.render import frame_graph
from superconductor_tpu_torch.render.caps import fit_caps
from superconductor_tpu_torch.render.frame import render_frame_impl
from superconductor_tpu_torch.scenes import all_passes_scene, headline_scene
from test_torch_sampler_card import (
    CLASSIC_CASES,
    MATERIAL_CASES,
    classic_args,
    material_args,
)

torch.set_num_threads(2)


def _j(t: torch.Tensor):
    return jnp.asarray(t.contiguous().numpy())


@pytest.mark.parametrize("case", sorted(CLASSIC_CASES))
def test_classic_sampler_matches_jax(case):
    args = classic_args(case)
    port = port_sample.sample_classic(**args).numpy()
    _pf, pi, mtm, mlv = ref_shade._material_rows({"mat_row": _j(args["mat_row"])},
                                                 _j(args["mat"]))
    ref = np.concatenate([np.asarray(ref_texture.sample_anisotropic(
        _j(args["pool"]), {}, pi[..., s], _j(args["uv"]), _j(args["duvdx"]),
        _j(args["duvdy"]), args["taps"], args["decode_srgb"],
        meta=mtm[..., 6 * s:6 * s + 6], levels_owh=mlv[..., s, :, :],
    )) for s in args["slots"]], axis=-1)
    assert port.shape == (args["uv"].shape[0], 4 * len(args["slots"]))
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", sorted(MATERIAL_CASES))
def test_material_sampler_matches_jax(case):
    args = material_args(case)
    port = port_sample.sample_material(**args).numpy()
    rows = args["rows"] if args["mat"] is None else args["rows"][args["mat"].long()]
    _pf, _pi, meta, owh = ref_shade._unpack_mq_row(_j(rows))
    tail = args["texels_tail"]
    ref = np.asarray(ref_texture.sample_material_interleaved(
        _j(args["texels_mq"]), meta, owh, _j(args["uv"]), _j(args["duvdx"]),
        _j(args["duvdy"]), args["taps"], args["decode_srgb"],
        texels_tail=None if tail is None else _j(tail),
    ))
    ref = np.concatenate([ref[:, 4 * s:4 * s + 4] for s in args["slots"]], axis=-1)
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)


def test_frame_samples_through_the_wrappers(monkeypatch):
    """A CPU frame calls both wrappers where their module binds them: the
    all-passes frame's material partition (both samplers) and the
    headline's shade (the whole interleaved pool)."""
    calls = []
    for name in ("sample_classic", "sample_material"):
        real = getattr(port_sample, name)

        def counted(*args, _name=name, _real=real, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(port_sample, name, counted)
    for make, kw in ((all_passes_scene, dict(stacks=8, lod_screen_height=32)),
                     (headline_scene, {})):
        dev, build, config, env = make(128, 64, "cpu", **kw)
        state = build(0.0)
        config = fit_caps(dev, state, config, env)
        before = len(calls)
        render_frame_impl(dev, state, config, env)
        assert len(calls) > before
    assert {"sample_classic", "sample_material"} <= set(calls)


@pytest.mark.parametrize("name", ["sample_classic", "sample_material"])
def test_rebinding_a_sampler_changes_the_graph_key(name, monkeypatch):
    scene, state = {"t": torch.zeros(3)}, (torch.zeros(2),)
    key = frame_graph.frame_key(scene, state, None, None, False)[0]
    assert frame_graph.frame_bindings_intact()
    monkeypatch.setattr(port_sample, name, getattr(port_sample, name + "_plain"))
    assert frame_graph.frame_key(scene, state, None, None, False)[0] != key
    assert not frame_graph.frame_bindings_intact()
    monkeypatch.undo()
    assert frame_graph.frame_bindings_intact()
    assert frame_graph.frame_key(scene, state, None, None, False)[0] == key


def _meta(args: dict) -> dict:
    return {k: v.to("meta") if isinstance(v, torch.Tensor) else v for k, v in args.items()}


def _segment_fault(ids_dtype=torch.int32, out_cols=0, out_dtype=torch.float32):
    """args with a (7,) lane_ids and an out of the wrong kind (meta)."""
    def fault(a):
        lanes, cols = a["uv"].shape[0], 4 * len(a["slots"])
        return dict(a, lane_ids=torch.zeros(7, dtype=ids_dtype, device="meta"),
                    out=torch.zeros((lanes, cols + out_cols), dtype=out_dtype, device="meta"))
    return fault


SEGMENT_FAULTS = {
    "lane_ids-dtype": _segment_fault(ids_dtype=torch.int64),
    "out-columns": _segment_fault(out_cols=4),
    "out-dtype": _segment_fault(out_dtype=torch.float16),
}
CLASSIC_FAULTS = {
    "pool-width": lambda a: dict(a, pool=torch.zeros((8, 8), dtype=torch.uint8, device="meta")),
    "pool-dtype": lambda a: dict(a, pool=a["pool"].to(torch.int32)),
    "uv-dtype": lambda a: dict(a, uv=a["uv"].to(torch.float64)),
    "uv-components": lambda a: dict(a, uv=torch.zeros((a["uv"].shape[0], 3), device="meta")),
    "mat-dtype": lambda a: dict(a, mat=a["mat"].to(torch.int64)),
    "mat_row-width": lambda a: dict(a, mat_row=a["mat_row"][:, :50]),
    "slots": lambda a: dict(a, slots=(0, 0)),
    "cpu-mat_row": lambda a: dict(a, mat_row=torch.zeros(a["mat_row"].shape)),
    **SEGMENT_FAULTS,
}
MATERIAL_FAULTS = {
    "pool-width": lambda a: dict(a, texels_mq=torch.zeros((8, 48), dtype=torch.uint8,
                                                          device="meta")),
    "tail-width": lambda a: dict(a, texels_tail=torch.zeros((8, 16), dtype=torch.uint8,
                                                            device="meta")),
    "rows-width": lambda a: dict(a, rows=a["rows"][:, :25]),
    "rows-a-lane-count": lambda a: dict(a, mat=None),
    "slots": lambda a: dict(a, slots=(4,)),
    **SEGMENT_FAULTS,
}


@pytest.mark.parametrize("fault", sorted(CLASSIC_FAULTS) + ["none"])
def test_classic_wrapper_raises_off_the_cpu(fault):
    """Meta tensors stand in for a card's: every layout the kernel does not
    take raises, and a good one raises too, off CUDA (no plain path)."""
    args = _meta(classic_args("taps1-repeat-quad"))
    if fault != "none":
        args = CLASSIC_FAULTS[fault](args)
    with pytest.raises((ValueError, TypeError),
                       match="CUDA tensors" if fault == "none" else None):
        port_sample.sample_classic(**args)


@pytest.mark.parametrize("fault", sorted(MATERIAL_FAULTS) + ["none"])
def test_material_wrapper_raises_off_the_cpu(fault):
    args = _meta(material_args("taps1-repeat-64+tail"))
    if fault != "none":
        args = MATERIAL_FAULTS[fault](args)
    with pytest.raises((ValueError, TypeError),
                       match="CUDA tensors" if fault == "none" else None):
        port_sample.sample_material(**args)


def test_cases_cover_the_layouts():
    """Every pool layout, wrap mode, tap count and row source is a case."""
    assert {(c[0], c[1], c[2]) for c in CLASSIC_CASES.values()} >= {
        (t, w, q) for t in (1, 2, 4) for w in (0, 1) for q in (False, True)}
    assert {c[2] for c in MATERIAL_CASES.values()} == {"64", "64+tail", "mq3"}
    assert {c[3] for c in MATERIAL_CASES.values()} == {True, False}
    assert {c[-1] for c in MATERIAL_CASES.values()} == {True, False}
    assert {c[-1] for c in CLASSIC_CASES.values()} == {True, False}

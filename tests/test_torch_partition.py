"""The material partition of partial interleaved pools on the CPU:
render/frame.py _partition_material_sample against the JAX package's
(superconductor_tpu/render/frame.py:565) on the all-passes tables, and the
samplers' segment form (lane_ids / out) that it calls.

The port finds each lane's place in the reference's sorted (incapable,
lane) order from a prefix count and samples each segment's lanes by id
into one result; the reference sorts, permutes, concatenates and permutes
back. Held at rtol 1e-5 / atol 1e-6 with classic_needed equal (XLA's and
torch's CPU log2 and pow differ by an ulp, tests/test_torch_shade.py), on
every shape of the two segments: incapable lanes spilling into the head,
slack (capable lanes in the tail), an empty head (cap_c = lanes), and
cap_c = 1; each with all four slots and with the albedo alone."""

import inspect
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_tpu.render import frame as ref_frame
from superconductor_tpu_torch.ops import sample as port_sample
from superconductor_tpu_torch.render import frame as port_frame
from test_torch_sampler_card import (
    SEGMENT_CASES,
    check_segment,
    gathered_args,
    kernel_case,
)
from test_torch_shade import _all_passes, _partition_lanes, _t

torch.set_num_threads(2)

LANES = 1024
# case -> the classic cap from the lanes' need (incapable valid lanes)
CAPS = {
    "spill": lambda need: max(1, need // 4),
    "slack": lambda need: need + 64,
    "empty-head": lambda need: LANES,
    "cap1": lambda need: 1,
}


def sorted_order(classic_lane: np.ndarray) -> np.ndarray:
    """The reference's order of the lanes: a sort of (incapable, lane)
    keys (superconductor_tpu/render/frame.py:565)."""
    lanes = classic_lane.shape[0]
    shift = max(int(lanes - 1).bit_length(), 1)
    keys = (classic_lane.astype(np.int64) << shift) | np.arange(lanes)
    return np.sort(keys) & ((1 << shift) - 1)


def _recorded(monkeypatch, compute: bool) -> list:
    """Both wrappers replaced where the partition looks them up: each call
    appended as (wrapper name, its arguments by name), then the real
    wrapper run (compute) or `out` returned as it is."""
    calls = []
    for name in ("sample_material", "sample_classic"):
        real = getattr(port_sample, name)
        sig = inspect.signature(real)

        def recorded(*args, _name=name, _real=real, _sig=sig, **kw):
            named = _sig.bind(*args, **kw).arguments
            calls.append((_name, named))
            return _real(*args, **kw) if compute else named["out"]

        monkeypatch.setattr(port_sample, name, recorded)
    return calls


@pytest.mark.parametrize("slots", [None, (0,)])
@pytest.mark.parametrize("case", sorted(CAPS))
def test_partition_matches_reference(case, slots, monkeypatch):
    dev_r, dev_p = _all_passes()
    lanes, need = _partition_lanes(11 + len(case), p=LANES)
    cap = CAPS[case](need)
    s_r, n_r = ref_frame._partition_material_sample(
        SimpleNamespace(**{k: jnp.asarray(v) for k, v in lanes.items()}), dev_r,
        ref_frame.RenderConfig(matq_classic_cap=cap), 1, slots=slots)
    calls = _recorded(monkeypatch, compute=True)
    g = SimpleNamespace(**{k: _t(v) for k, v in lanes.items()})
    s_p, n_p = port_frame._partition_material_sample(
        g, dev_p, port_frame.RenderConfig(matq_classic_cap=cap), 1, slots=slots)
    assert int(n_p) == int(n_r) == need > 0
    assert s_p.shape == (LANES, 4 * (4 if slots is None else len(slots)))
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_r), rtol=1e-5, atol=1e-6)

    # the segments are the reference's: head then tail of its sorted order
    capable = dev_p["matq_capable"].numpy()[np.maximum(lanes["material"], 0)]
    order = sorted_order(~capable & lanes["valid"])
    cap_c = max(1, min(cap, LANES))
    n_h = LANES - cap_c
    names = [name for name, _ in calls]
    assert names == (["sample_material"] if n_h else []) + ["sample_classic"]
    segments = [kw["lane_ids"].numpy() for _, kw in calls]
    assert np.array_equal(np.concatenate(segments), order)
    assert [len(ids) for ids in segments] == ([n_h] if n_h else []) + [cap_c]
    if case == "slack":
        assert (capable[segments[-1]]).any()  # the last capable lanes take the tail
    if case in ("spill", "cap1"):
        assert (~capable[segments[0]] & lanes["valid"][segments[0]]).any()


SORTS_AND_GATHERS = ("sort", "argsort", "cat", "concat", "concatenate", "index_select",
                     "gather", "take", "take_along_dim")


@pytest.mark.parametrize("case", sorted(CAPS))
def test_partition_neither_sorts_nor_permutes(case, monkeypatch):
    """Inside the partition torch's sorts, concatenations and gathers raise;
    the samplers get the g-buffer's own tensors, the second sampler the
    first's result as its out, and the partition returns the last one's
    result as it is."""
    _dev_r, dev_p = _all_passes()
    lanes, need = _partition_lanes(11 + len(case), p=LANES)
    calls = _recorded(monkeypatch, compute=False)

    def forbidden(*args, **kw):
        raise AssertionError("the partition sorted, concatenated or gathered")

    for name in SORTS_AND_GATHERS:
        for owner in (torch, torch.Tensor):
            if hasattr(owner, name):
                monkeypatch.setattr(owner, name, forbidden)
    g = SimpleNamespace(**{k: _t(v) for k, v in lanes.items()})
    s, _n = port_frame._partition_material_sample(
        g, dev_p, port_frame.RenderConfig(matq_classic_cap=CAPS[case](need)), 1)
    monkeypatch.undo()
    assert calls
    for _name, kw in calls:
        assert kw["uv"] is g.uv and kw["duvdx"] is g.duvdx and kw["duvdy"] is g.duvdy
        assert kw["mat"] is g.material
    outs = [kw["out"] for _, kw in calls]
    assert all(out is outs[0] for out in outs) and s is outs[0]


@pytest.mark.parametrize("kernel,case", SEGMENT_CASES)
def test_plain_segment_equals_dense_plain(kernel, case):
    """The plain versions with lane_ids / out: the segment's rows equal the
    dense plain call on the gathered lanes bit for bit, and out's other
    rows keep what they held."""
    _wrapper, plain, args = kernel_case(kernel, case)
    check_segment(plain(**args), args, plain(**gathered_args(args)))


@pytest.mark.parametrize("kernel", ["classic", "material"])
@pytest.mark.parametrize("given", ["lane_ids", "out"])
def test_lane_ids_and_out_go_together(kernel, given):
    wrapper, plain, args = kernel_case(kernel, "taps1-clamp-" + (
        "quad" if kernel == "classic" else "64+tail"))
    args[{"lane_ids": "out", "out": "lane_ids"}[given]] = None
    for fn in (wrapper, plain):
        with pytest.raises(ValueError, match="lane_ids and out go together"):
            fn(**args)

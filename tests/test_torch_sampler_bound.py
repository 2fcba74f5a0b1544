"""chip_smoke.py's bound of the material samplers, on the CPU: the bytes it
charges follow what csrc/sample.cu reads. The kernels read level b of a
trilinear sample only where the level fraction is not 0, so
chip_smoke.level_b_read must mark exactly those lanes, and
chip_smoke.texel_sectors must charge level b's texel sectors only there.

On the seeded cases of tests/test_torch_sampler_card.py, every lane and
on a segment: level_b_read equals the fraction of the lod the plain chain
itself computes (the classic chain's lod as sample_trilinear receives it,
the interleaved chain's as its trilinear floors it); with every lane
reading level b, texel_sectors charges the sectors of every row the plain
version fetches; with the lanes level_b_read marks it charges fewer."""

import inspect
import types

import pytest
import torch

import chip_smoke
from superconductor_tpu_torch.ops import sample as port_sample
from superconductor_tpu_torch.ops import texture as port_texture
from test_torch_sampler_card import (
    CLASSIC_CASES,
    MATERIAL_CASES,
    classic_args,
    material_args,
    segment_args,
)

torch.set_num_threads(2)

CASES = [("classic", c) for c in sorted(CLASSIC_CASES)] + \
    [("material", c) for c in sorted(MATERIAL_CASES)]


def _call(kernel: str, case: str, segment: bool) -> dict:
    """The case's arguments by name as the wrapper binds them (lane_ids and
    out None without a segment)."""
    args = classic_args(case) if kernel == "classic" else material_args(case)
    if segment:
        args = segment_args(args, 7)
    plain = getattr(port_sample, f"sample_{kernel}_plain")
    bound = inspect.signature(plain).bind(**args)
    bound.apply_defaults()
    return dict(bound.arguments)


def _chain_lods(kernel: str, args: dict, monkeypatch) -> tuple:
    """(the texel fetches, the lods) of one plain call: each lod the classic
    chain hands sample_trilinear (a slot's taps in turn), or the
    interleaved chain's one lod, the first tensor it floors."""
    lods = []
    if kernel == "classic":
        real = port_texture.sample_trilinear

        def trilinear(*a, **kw):
            lods.append(a[4])
            return real(*a, **kw)

        monkeypatch.setattr(port_texture, "sample_trilinear", trilinear)
    else:
        floors = []

        def floor(x):
            floors.append(x)
            return torch.floor(x)

        proxy = types.SimpleNamespace(**{k: getattr(torch, k) for k in dir(torch)
                                         if not k.startswith("__")})
        proxy.floor = floor
        monkeypatch.setattr(port_texture, "torch", proxy)
    plain = getattr(port_sample, f"sample_{kernel}_plain")
    with chip_smoke.recorded_fetches() as fetched:
        plain(**chip_smoke.fresh_out(args))
    monkeypatch.undo()
    if kernel == "material":
        # the first floor of the chain is its first trilinear's lod, which
        # every tap shares
        lods = floors[:1]
    return fetched, lods


@pytest.mark.parametrize("segment", [False, True], ids=["every_lane", "segment"])
@pytest.mark.parametrize("kernel,case", CASES)
def test_level_b_read_follows_the_chains_lod(kernel, case, segment, monkeypatch):
    args = _call(kernel, case, segment)
    _fetched, lods = _chain_lods(kernel, args, monkeypatch)
    taps = max(1, int(args["taps"]))
    per_row = taps if kernel == "classic" else len(lods)
    want = torch.stack([lods[i] - torch.floor(lods[i]) != 0
                        for i in range(0, len(lods), per_row)])
    read_b = chip_smoke.level_b_read(f"sample_{kernel}", args)
    assert torch.equal(read_b, want)
    assert 0 < int(read_b.sum()) < read_b.numel()  # both kinds of lane in every case


@pytest.mark.parametrize("segment", [False, True], ids=["every_lane", "segment"])
@pytest.mark.parametrize("kernel,case", CASES)
def test_texel_sectors_charge_level_b_where_it_is_read(kernel, case, segment, monkeypatch):
    args = _call(kernel, case, segment)
    fetched, _lods = _chain_lods(kernel, args, monkeypatch)
    slots = args["slots"]
    read_b = chip_smoke.level_b_read(f"sample_{kernel}", args)
    every = 0
    for pool, rows in chip_smoke.fetched_rows(fetched):
        width = pool.shape[1] * pool.element_size()
        spans = {4: [(0, 4)], 16: [(0, 16)], 64: [(16 * s, 16) for s in slots],
                 208: [(16 * s, 16) for s in slots] + [(64 + 36 * s, 36) for s in slots]}[width]
        base = pool.data_ptr() + torch.unique(rows) * width
        every += torch.unique(torch.cat([chip_smoke.sector_ids(base + off, n)
                                         for off, n in spans])).numel()
    assert chip_smoke.texel_sectors(fetched, slots, torch.ones_like(read_b)) == every
    assert chip_smoke.texel_sectors(fetched, slots, read_b) < every

"""The material samplers' CUDA kernels (csrc/sample.cu) against their plain
versions on the card, bit for bit: ops/sample.py sample_classic
(classic_sample_kernel) and sample_material (material_sample_kernel), on
the cases that tests/test_torch_sampler.py holds the plain versions to the
JAX package with. This file imports no JAX: its tests run only where there
is a card (-m gpu) and skip elsewhere.

    python -m pytest -q -m gpu tests/test_torch_sampler_card.py

The cases also serve tests/test_torch_sampler.py: seeded textures in
scenes built by the port's host layer (scene_to_torch), and lanes whose uv
reach outside [0, 1] (negative texel coordinates), whose footprints run
from far below a texel (lod clamped to 0) to past the end of every chain,
and whose material ids include negative ones (torch's indexing counts them
from the end).

Each case also runs on a segment of its lanes (segment_args): an ascending
random subset of SEGMENT lanes (a multiple of none of 4, 32 and 256) read
in place by lane_ids and written to their own rows of an `out` whose other
rows hold a sentinel NaN pattern, as the material partition calls both
samplers."""

import functools

import numpy as np
import pytest
import torch

from superconductor_tpu_torch.ops import sample as port_sample
from superconductor_tpu_torch.ops import texture as port_texture
from superconductor_tpu_torch.scene.scene import (
    TEXFLAG_SRGB,
    MaterialSettings,
    Scene,
    build_mip_chain,
)
from superconductor_tpu_torch.scene.upload import scene_to_torch

torch.set_num_threads(2)

LANES = 2048
# name -> (taps, wrap, quad pool, slots, decode_srgb)
CLASSIC_CASES = {
    f"taps{taps}-{'clamp' if wrap else 'repeat'}-{'quad' if quad else 'flat'}":
        (taps, wrap, quad, (0, 1, 2, 3) if taps != 2 else (0,), True)
    for taps in (1, 2, 4) for wrap in (0, 1) for quad in (False, True)
}
CLASSIC_CASES["no-srgb-decode"] = (4, 0, True, (0, 1, 2, 3), False)
CLASSIC_CASES["slots-3-1"] = (1, 1, True, (3, 1), True)
# name -> (taps, wrap, rows: "64" | "64+tail" | "mq3", by material id, slots, decode_srgb)
MATERIAL_CASES = {
    f"taps{taps}-{'clamp' if wrap else 'repeat'}-{rows}": (
        taps, wrap, rows, taps != 2, (0, 1, 2, 3) if taps != 4 else (0,), True)
    for taps in (1, 2, 4) for wrap in (0, 1) for rows in ("64", "64+tail", "mq3")
}
MATERIAL_CASES["no-srgb-decode"] = (2, 0, "64+tail", True, (0, 1, 2, 3), False)
MATERIAL_CASES["slots-2-0"] = (1, 1, "mq3", True, (2, 0), True)


def _texture(scene, rng, h, w, wrap, srgb):
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    return scene.textures.add_texture(build_mip_chain(img), wrap=wrap,
                                      flags=TEXFLAG_SRGB if srgb else 0)


@functools.lru_cache(maxsize=None)
def classic_tables(wrap: int, quad: bool):
    """(LDR pool, mat_row) numpy: three materials of textures of unequal,
    non-square sizes (sRGB and linear), one sampling the dummy textures in
    three slots; the quad-packed (N, 16) or the flat (N, 4) pool."""
    scene = Scene()
    scene.quad_pools = quad
    scene.matq_pools = False
    rng = np.random.default_rng(20 + wrap)
    scene.add_material(MaterialSettings(
        albedo_tex=_texture(scene, rng, 32, 16, wrap, True),
        normal_tex=_texture(scene, rng, 16, 16, wrap, False),
        metallic_roughness_tex=_texture(scene, rng, 8, 64, wrap, False),
        emissive_tex=_texture(scene, rng, 4, 4, wrap, True)))
    scene.add_material(MaterialSettings(albedo_tex=_texture(scene, rng, 8, 8, wrap, True)))
    scene.add_material(MaterialSettings(
        albedo_tex=_texture(scene, rng, 64, 32, wrap, False),
        normal_tex=_texture(scene, rng, 2, 2, wrap, True)))
    dev = scene_to_torch(scene, "cpu")
    pool = port_texture.ldr_pool(dev)
    assert pool.shape[1] == (16 if quad else 4)
    return pool.numpy(), dev["materials"]["mat_row"].numpy()


@functools.lru_cache(maxsize=None)
def material_tables(wrap: int, mq3: bool):
    """(texels_mq, texels_mq_tail or None, mat_row_mq) numpy: two
    materials of four equal-size textures each (32^2 and 16^2, sRGB in
    different slots), as the wide mq3 rows or the 64-B rows with a tail."""
    scene = Scene()
    scene.matq3x3 = mq3
    rng = np.random.default_rng(40 + wrap)
    for size, srgb in ((32, (True, False, False, True)), (16, (False, True, True, False))):
        ids = [_texture(scene, rng, size, size, wrap, s) for s in srgb]
        scene.add_material(MaterialSettings(albedo_tex=ids[0], normal_tex=ids[1],
                                            metallic_roughness_tex=ids[2], emissive_tex=ids[3]))
    dev = scene_to_torch(scene, "cpu")
    assert "matq_capable" not in dev and dev["texels_mq"].shape[1] == (208 if mq3 else 64)
    tail = dev.get("texels_mq_tail")
    assert (tail is None) == mq3
    return (dev["texels_mq"].numpy(), None if tail is None else tail.numpy(),
            dev["materials"]["mat_row_mq"].numpy())


def lanes(seed: int, n_mat: int, p: int = LANES):
    """(mat (p,) i32 in [-n_mat, n_mat), uv, duvdx, duvdy (p, 2) f32)."""
    rng = np.random.default_rng(seed)
    mat = rng.integers(-n_mat, n_mat, size=p).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (p, 2)).astype(np.float32)
    scale = 10.0 ** rng.uniform(-6.0, 1.0, (p, 1))
    dx = (rng.normal(size=(p, 2)) * scale).astype(np.float32)
    dy = (rng.normal(size=(p, 2)) * scale).astype(np.float32)
    return mat, uv, dx, dy


def classic_args(case: str, device="cpu"):
    """sample_classic's arguments for CLASSIC_CASES[case] (the lanes'
    inputs as views of one (P, 7) buffer, as the material partition
    passes them), and its slots."""
    taps, wrap, quad, slots, decode = CLASSIC_CASES[case]
    pool, mat_row = classic_tables(wrap, quad)
    mat, uv, dx, dy = lanes(100 + taps + 10 * wrap, mat_row.shape[0])
    buf = torch.from_numpy(np.concatenate([uv, dx, dy, mat.view(np.float32)[:, None]], 1))
    buf = buf.to(device)
    return dict(pool=torch.from_numpy(pool).to(device),
                mat_row=torch.from_numpy(mat_row).to(device),
                mat=buf.view(torch.int32)[:, 6], uv=buf[:, 0:2], duvdx=buf[:, 2:4],
                duvdy=buf[:, 4:6], taps=taps, slots=slots, decode_srgb=decode)


def material_args(case: str, device="cpu"):
    """sample_material's arguments for MATERIAL_CASES[case]: by material
    id (the (P, 7) buffer, as the partition passes them) or a row a lane
    (a strided view of wider rows, as the g-buffer's mat_tail)."""
    taps, wrap, rows, by_id, slots, decode = MATERIAL_CASES[case]
    texels, tail, table = material_tables(wrap, rows == "mq3")
    mat, uv, dx, dy = lanes(200 + taps + 10 * wrap, table.shape[0])
    buf = torch.from_numpy(np.concatenate([uv, dx, dy, mat.view(np.float32)[:, None]], 1))
    buf = buf.to(device)
    table_t = torch.from_numpy(table).to(device)
    args = dict(texels_mq=torch.from_numpy(texels).to(device), uv=buf[:, 0:2],
                duvdx=buf[:, 2:4], duvdy=buf[:, 4:6], taps=taps, slots=slots,
                decode_srgb=decode,
                texels_tail=torch.from_numpy(tail).to(device) if rows == "64+tail" else None)
    if by_id:
        args.update(rows=table_t, mat=buf.view(torch.int32)[:, 6])
    else:
        wide = torch.zeros((LANES, 48 + table.shape[1] + 8), dtype=torch.float32, device=device)
        wide[:, 48:48 + table.shape[1]] = table_t[torch.from_numpy(mat).long().to(device)]
        args.update(rows=wide[:, 48:48 + table.shape[1]], mat=None)
    return args


SEGMENT = 1237  # lanes of a segment: not a multiple of 4, 32 or 256
SENTINEL = 0x7FBADBAD  # a NaN pattern no sampler writes


def segment_args(args: dict, seed: int) -> dict:
    """args with lane_ids (an ascending random subset of SEGMENT lanes,
    int32) and out (P, 4 * len(slots)) f32 filled with SENTINEL's bits."""
    lanes = args["uv"].shape[0]
    dev = args["uv"].device
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(lanes, SEGMENT, replace=False)).astype(np.int32)
    out = torch.full((lanes, 4 * len(args["slots"])), SENTINEL, dtype=torch.int32, device=dev)
    return dict(args, lane_ids=torch.from_numpy(ids).to(dev), out=out.view(torch.float32))


def gathered_args(args: dict) -> dict:
    """The dense call on the lanes of segment_args(args): each per-lane
    input (and a row-a-lane table) at lane_ids, no lane_ids nor out."""
    idx = args["lane_ids"].long()
    per_lane = ["uv", "duvdx", "duvdy", "mat"] + (["rows"] if args["mat"] is None else [])
    return {k: (v[idx] if k in per_lane and v is not None else v)
            for k, v in args.items() if k not in ("lane_ids", "out")}


def check_segment(out: torch.Tensor, args: dict, want: torch.Tensor) -> None:
    """out is args' out, its rows at lane_ids bit for bit want (the dense
    result on the gathered lanes) and every other row still SENTINEL."""
    assert out is args["out"]
    idx = args["lane_ids"].long()
    _bit_equal(out[idx], want)
    others = torch.ones(out.shape[0], dtype=torch.bool, device=out.device)
    others[idx] = False
    assert bool((out.view(torch.int32)[others] == SENTINEL).all()), "rows outside the segment"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (csrc/sample.cu has no CPU mode)")
    return torch.device("cuda", 0)


def _bit_equal(out: torch.Tensor, want: torch.Tensor) -> None:
    assert out.shape == want.shape and out.dtype == want.dtype == torch.float32
    same = out.view(torch.int32) == want.view(torch.int32)
    assert bool(same.all()), (
        f"{int((~same).sum())} of {same.numel()} values differ, max abs "
        f"{float((out.double() - want.double()).abs().nan_to_num().max())}")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CLASSIC_CASES))
def test_classic_kernel_equals_plain_on_card(case):
    dev = _card()
    args = classic_args(case, dev)
    before = port_sample.sample_classic.LAUNCHES
    out = port_sample.sample_classic(**args)
    torch.cuda.synchronize()
    assert port_sample.sample_classic.LAUNCHES == before + 1
    _bit_equal(out, port_sample.sample_classic_plain(**args))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(MATERIAL_CASES))
def test_material_kernel_equals_plain_on_card(case):
    dev = _card()
    args = material_args(case, dev)
    before = port_sample.sample_material.LAUNCHES
    out = port_sample.sample_material(**args)
    torch.cuda.synchronize()
    assert port_sample.sample_material.LAUNCHES == before + 1
    _bit_equal(out, port_sample.sample_material_plain(**args))


SEGMENT_CASES = ([("classic", c) for c in sorted(CLASSIC_CASES)]
                 + [("material", c) for c in sorted(MATERIAL_CASES)])


def kernel_case(kernel: str, case: str, device="cpu") -> tuple:
    """(wrapper, plain version, segment_args of the case's arguments)."""
    make = classic_args if kernel == "classic" else material_args
    return (getattr(port_sample, f"sample_{kernel}"),
            getattr(port_sample, f"sample_{kernel}_plain"),
            segment_args(make(case, device), seed=len(case)))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,case", SEGMENT_CASES)
def test_kernel_on_a_segment_equals_plain_on_card(kernel, case):
    """lane_ids / out: the kernel writes the segment's rows bit for bit as
    the plain version, leaves the others, and launches once."""
    wrapper, plain, args = kernel_case(kernel, case, _card())
    before = wrapper.LAUNCHES
    out = wrapper(**args)
    torch.cuda.synchronize()
    assert wrapper.LAUNCHES == before + 1
    check_segment(out, args, plain(**gathered_args(args)))
    again = segment_args(args, seed=len(case))
    assert plain(**again) is again["out"]
    _bit_equal(out, again["out"])

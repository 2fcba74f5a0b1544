"""The port's host encoders against the reference's: the ETC1S KTX2 writer
(assets/basislz.py) and the three meshopt encoders (assets/meshopt.py) on
seeded inputs give the reference's bytes exactly, and each result decodes
through the port's own decoders (the scnative library) to what the
reference's decoders give; the port's pure-Python meshopt decoders
round-trip the encoders' streams as the reference's do."""

import numpy as np
import pytest
import torch

from superconductor_tpu.assets import basislz as ref_basislz
from superconductor_tpu.assets import ktx2 as ref_ktx2
from superconductor_tpu.assets import meshopt as ref_meshopt
from superconductor_tpu_torch.assets import basislz, ktx2, meshopt
import test_torch_host  # noqa: F401  (pins the reference's native library)

# The test workers share the CPU: torch's default of a thread per core in
# each of them oversubscribes it many times over.
torch.set_num_threads(2)


def _image(seed: int, h: int = 37, w: int = 53) -> np.ndarray:
    """A smooth gradient with a seeded noisy patch and a flat patch of
    another alpha (edge blocks ragged: 37 x 53 is no multiple of 4)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 / (w - 1), y * 255 / (h - 1), (x + y) * 255 / (w + h - 2),
                    np.full((h, w), 200.0)], -1).astype(np.uint8)
    img[20:32, 28:48] = rng.integers(0, 256, (12, 20, 4), dtype=np.uint8)
    img[4:12, 4:20] = (30, 200, 90, 128)
    return img


@pytest.mark.parametrize("num_levels", [1, 3])
@pytest.mark.parametrize("with_alpha", [False, True])
@pytest.mark.parametrize("use_rle", [False, True])
def test_write_etc1s_ktx2_matches_reference(num_levels, with_alpha, use_rle):
    """Byte-equal KTX2 files (RLE runs need the selector history, so it is
    on with RLE), and every level decodes through the port's parser and
    native transcoder to the reference's texels, near the source image."""
    img = _image(num_levels * 4 + with_alpha * 2 + use_rle)
    kw = dict(num_levels=num_levels, with_alpha=with_alpha, use_rle=use_rle,
              history_size=16 if use_rle else 0, raw_selectors=not use_rle)
    blob = basislz.write_etc1s_ktx2(img, **kw)
    assert blob == ref_basislz.write_etc1s_ktx2(img, **kw)
    k, rk = ktx2.parse_ktx2(blob), ref_ktx2.parse_ktx2(blob)
    assert k.is_etc1s and len(k.levels) == num_levels
    for lvl in range(num_levels):
        out = ktx2.decode_level_u8(k, lvl)
        assert np.array_equal(out, ref_ktx2.decode_level_u8(rk, lvl))
    out = ktx2.decode_level_u8(k, 0)
    assert out.shape == img.shape
    assert np.abs(out[..., :3].astype(int) - img[..., :3].astype(int)).mean() < 12
    if with_alpha:
        assert np.abs(out[..., 3].astype(int) - img[..., 3].astype(int)).mean() < 12
    else:
        assert (out[..., 3] == 255).all()


def _vertices(stride: int, count: int = 300) -> np.ndarray:
    """Seeded vertex bytes: a smooth ramp (small deltas, the 4-bit groups),
    noise (full-byte groups) and a constant column (empty groups); 300
    vertices span two blocks."""
    rng = np.random.default_rng(stride)
    v = rng.integers(0, 256, (count, stride), dtype=np.uint8)
    v[:, 0] = (np.arange(count) // 3) & 0xFF
    v[:, 1] = 7
    return v


def _indices(count: int = 3 * 96) -> np.ndarray:
    """Seeded triangle indices: a strip-like walk with jumps back and far."""
    rng = np.random.default_rng(5)
    base = np.repeat(np.arange(count // 3), 3) + np.tile([0, 1, 2], count // 3)
    jumps = rng.integers(0, 70000, count) * (rng.random(count) < 0.1)
    return (base + jumps).astype(np.uint32)


@pytest.mark.parametrize("case", ["vertex-12", "vertex-16", "index-buffer", "index-sequence"])
def test_meshopt_encoders_match_reference(case):
    """Byte-equal streams, decoded by the port's native decoder back to the
    input (decode_buffer_view, the path the glTF loader takes)."""
    if case.startswith("vertex"):
        stride = int(case.split("-")[1])
        verts = _vertices(stride)
        data = meshopt.encode_vertex_buffer(verts)
        assert data == ref_meshopt.encode_vertex_buffer(verts)
        out = meshopt.decode_buffer_view(data, "ATTRIBUTES", len(verts), stride)
        assert np.array_equal(out.reshape(verts.shape), verts)
        return
    idx = _indices()
    if case == "index-buffer":
        data, mode = meshopt.encode_index_buffer(idx), "TRIANGLES"
        assert data == ref_meshopt.encode_index_buffer(idx)
    else:
        data, mode = meshopt.encode_index_sequence(idx), "INDICES"
        assert data == ref_meshopt.encode_index_sequence(idx)
    out = meshopt.decode_buffer_view(data, mode, len(idx), 4)
    assert np.array_equal(out.view(np.uint32), idx)


@pytest.mark.parametrize("case", ["vertex-12", "vertex-16", "index-buffer", "index-sequence"])
def test_meshopt_python_decoders_round_trip(case):
    """The pure-Python decoders (decode_vertex_buffer, decode_index_buffer,
    decode_index_sequence) take the encoders' streams back to the input,
    equal to the reference's Python decoders and the port's native decode
    (decode_buffer_view)."""
    if case.startswith("vertex"):
        stride = int(case.split("-")[1])
        verts = _vertices(stride)
        data = meshopt.encode_vertex_buffer(verts)
        out = meshopt.decode_vertex_buffer(data, len(verts), stride)
        assert np.array_equal(out, verts)
        assert np.array_equal(out, ref_meshopt.decode_vertex_buffer(data, len(verts), stride))
        native = meshopt.decode_buffer_view(data, "ATTRIBUTES", len(verts), stride)
        assert np.array_equal(native.reshape(verts.shape), out)
        return
    idx = _indices()
    if case == "index-buffer":
        data, mode, fn = meshopt.encode_index_buffer(idx), "TRIANGLES", "decode_index_buffer"
    else:
        data, mode, fn = meshopt.encode_index_sequence(idx), "INDICES", "decode_index_sequence"
    out = getattr(meshopt, fn)(data, len(idx))
    assert np.array_equal(np.asarray(out, np.uint32), idx)
    ref = getattr(ref_meshopt, fn)(data, len(idx))
    assert np.asarray(out).dtype == np.asarray(ref).dtype and np.array_equal(out, ref)
    native = meshopt.decode_buffer_view(data, mode, len(idx), 4)
    assert np.array_equal(native.view(np.uint32), np.asarray(out, np.uint32))

"""The port's skybox against the JAX package's on the CPU: ops/sky.py
sample_skybox and sample_skybox_at (the wrappers of csrc/sky.cu's kernel,
which take their plain versions for CPU tensors) against
superconductor_tpu/ops/sky.py's on the same seeded numpy inputs at 64x32
(tests/test_torch_deferred_card.py SKY_CASES): a band with y_offset > 0 of
a taller image, a band 61 pixels wide, a one-row band at a large
y_offset, both inline flags, the static placement with f16, f32 and
u8 pools, quad-packed and flat, the descriptor placement (faces of unequal
sizes, REPEAT and CLAMP), the worklist at int32 and int64 indices (one
ending in dead lanes), the clear colour, and rays exactly through the
cube's edges and corners.

Tolerance: bit for bit without the sRGB encode (measured: every case
equal). With it, `** (1 / 2.2)` is XLA's CPU pow on one side and torch's
on the other, which differ by an ulp: compared at 1 ulp of the values,
which lie in [0, 1] (rtol 2 ** -23, atol 2 ** -24).

Also the g-buffer's row layouts against the JAX package (its hero-scene
test is tests/test_torch_shade.py test_interpolate_gbuffer_matches_reference):
the seeded rows of GBUFFER_CASES, NaN, +-inf and -0 included, equal in
value on every field (NaN where the JAX package has NaN; measured: the
bits differ only where XLA's sum of three zeros gives +0 and the port's
(a + b) + c gives -0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_tpu.ops import shade as ref_shade
from superconductor_tpu.ops import sky as ref_sky
from superconductor_tpu.ops.geometry import TriangleAttrs as RefAttrs
from superconductor_tpu.ops.geometry import TriangleSetup as RefSetup
from superconductor_tpu.render.env import EnvBindings as RefEnv
from superconductor_tpu_torch.ops import shade as port_shade
from superconductor_tpu_torch.ops import sky as port_sky
from test_torch_deferred_card import (GBUFFER_CASES, SKY_CASES, SKY_WIDTHS, gbuffer_args,
                                      sky_args)

torch.set_num_threads(2)


def _j(x):
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.contiguous().numpy())
    if isinstance(x, dict):
        return {k: _j(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("case", sorted(SKY_CASES))
def test_sky_matches_jax(case):
    name, args = sky_args(case)
    port = getattr(port_sky, name)(**args).numpy()
    _name, ref_args = sky_args(case, env_cls=RefEnv)
    ref = np.asarray(getattr(ref_sky, name)(**{k: _j(v) for k, v in ref_args.items()}))
    lanes = args["idx"].shape[0] if "idx" in args else args["height"] * args["width"]
    assert port.shape == ref.shape == (lanes, 3) and port.dtype == ref.dtype == np.float32
    assert np.isfinite(port).all()
    if args["inline_srgb"]:
        np.testing.assert_allclose(port, ref, rtol=2.0 ** -23, atol=2.0 ** -24)
    else:
        np.testing.assert_array_equal(port.view(np.int32), ref.view(np.int32))


def test_sky_cases_cover_the_inputs():
    """Every pool layout and texel type, both placements and the clear
    colour, both inline flags, the band, the worklist at both index types
    and the edge camera are cases."""
    cases = SKY_CASES.values()
    assert {(c[0], c[1]) for c in cases if c[2] == "static"} >= {
        ("quad", "f16"), ("quad", "f32"), ("quad", "u8"), ("flat", "f32"), ("flat", "u8")}
    assert {c[2] for c in cases} == {"static", "desc", "clear"}
    assert {c[4] for c in cases} >= {(True, True), (False, False), (True, False), (False, True)}
    assert any(c[5] is not None and c[5][1] > 0 and c[6] is None for c in cases)
    assert {c[6] for c in cases} == {None, "i32", "i64", "i32-dead"}
    assert {c[3] for c in cases} == {"random", "edges"}
    # a band of an odd width (not a multiple of the kernel's 2 pixels a
    # thread, nor of 4), a one-row band at a large y_offset, a worklist of
    # an odd length that ends in dead lanes
    assert any(SKY_CASES[c][6] is None and w % 2 for c, w in SKY_WIDTHS.items())
    assert any(c[5] is not None and c[5][0] == 1 and c[5][1] >= 1000 and c[6] is None
               for c in cases)
    dead = [c for c, v in SKY_CASES.items() if (v[6] or "").endswith("-dead")]
    assert dead and all(sky_args(c)[1]["idx"].shape[0] % 2 for c in dead)


@pytest.mark.parametrize("case", GBUFFER_CASES)
def test_gbuffer_row_layouts_match_jax(case):
    args = gbuffer_args(case)
    port = port_shade.interpolate_gbuffer(**args)
    tri, attrs = args["tri"], args["attrs"]
    ref = ref_shade.interpolate_gbuffer(
        _j(args["pair"]), _j(args["px"]), _j(args["py"]),
        RefSetup(*[_j(x) for x in tri]), RefAttrs(*[_j(x) for x in attrs]),
        shade_row=None if args["shade_row"] is None else _j(args["shade_row"]),
        row_cols=args["row_cols"],
    )
    assert (ref.mat_tail is None) == (port.mat_tail is None) == (case in ("shade-no-tail",
                                                                          "tables", "strided"))
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(port, f)
        if a is None:
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)

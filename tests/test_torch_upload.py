"""The port's scene upload against the reference's Scene.device_arrays():
every key, bit for bit, on the hero fixture and the test box, each side
loading the asset with its own host layer."""

import os

import numpy as np
import pytest
import torch

from superconductor_tpu.assets.models import load_model
from superconductor_tpu.scene import scene as ref_scene_mod
from superconductor_tpu.scene.scene import Scene
from superconductor_tpu_torch.assets.models import load_model as port_load_model
from superconductor_tpu_torch.scene import scene as port_scene_mod
from superconductor_tpu_torch.scene.scene import Scene as PortScene
from superconductor_tpu_torch.scene.upload import arrays_to_torch, scene_to_torch

HERO = os.path.join(os.path.dirname(__file__), "fixtures", "hero_helmet.glb")


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.uint8).reshape(-1)


def _assert_same_tables(ref: dict, port: dict):
    ref_f = _flatten(ref)
    port_f = _flatten(port)
    assert sorted(ref_f) == sorted(port_f)
    for k, v in ref_f.items():
        r = np.asarray(v)
        p = port_f[k].numpy()
        assert r.shape == p.shape, k
        # u32 index buffers travel as i32 with the same bits
        assert r.dtype.itemsize == p.dtype.itemsize, k
        if r.dtype != np.uint32:
            assert r.dtype == p.dtype, k
        assert np.array_equal(_bits(r), _bits(p)), k


def _scene_of(glb: bytes) -> Scene:
    scene = Scene()
    load_model(scene, glb, name="m")
    return scene


def _port_scene_of(glb: bytes) -> PortScene:
    scene = PortScene()
    port_load_model(scene, glb, name="m")
    return scene


@pytest.mark.parametrize("which", ["hero", "box", "all_passes", "lit_passes"])
def test_scene_to_torch_bit_exact(which, box_glb):
    """hero and box: one model; all_passes: the terrain and the sphere ring,
    whose interleaved pool is partial (matq_capable, the incapable
    terrain material's sentinel mat_row_mq row); lit_passes: all_passes
    with the light volume, the lightmapped wall and the smoke maps, so the
    SH-interleaved pools (lv_sh, lm_sh) and the smoke pool (smoke_ab,
    smoke_lut) too."""
    if which == "lit_passes":
        from superconductor_tpu_torch.scenes import LIT_PASSES_SMALL, lit_passes_host
        from test_torch_host import REF_HOST

        ref = lit_passes_host(**LIT_PASSES_SMALL, host=REF_HOST)[0].device_arrays()
        port = scene_to_torch(lit_passes_host(**LIT_PASSES_SMALL)[0], "cpu")
        assert {"lv_sh", "lm_sh", "smoke_ab", "smoke_lut", "matq_capable"} <= set(port)
        assert port["lv_sh"].shape == (96 * 48 * 48, 48) and port["lv_sh"].dtype == torch.float16
        _assert_same_tables(ref, port)
        return
    if which == "all_passes":
        from superconductor_tpu_torch.scenes import ALL_PASSES_SMALL, all_passes_host
        from test_torch_host import REF_HOST

        ref = all_passes_host(**ALL_PASSES_SMALL, host=REF_HOST)[0].device_arrays()
        port = scene_to_torch(all_passes_host(**ALL_PASSES_SMALL)[0], "cpu")
        assert "matq_capable" in port and not bool(port["matq_capable"].all())
        _assert_same_tables(ref, port)
        return
    if which == "hero":
        with open(HERO, "rb") as f:
            glb = f.read()
    else:
        glb = box_glb
    ref = _scene_of(glb).device_arrays()
    port = scene_to_torch(_port_scene_of(glb), "cpu")
    _assert_same_tables(ref, port)
    # the converter feeds both packages identical inputs
    _assert_same_tables(ref, arrays_to_torch(ref, "cpu"))


def _material_scene(mod, size: int):
    """A scene (of scene module `mod`) with one material of four seeded
    size^2 textures (the reference's tests/test_matq.py
    _full_material_scene)."""
    scene = mod.Scene()
    ids = []
    for seed, flags in ((1, mod.TEXFLAG_SRGB), (2, 0), (3, 0), (4, mod.TEXFLAG_SRGB)):
        img = np.random.default_rng(seed).integers(0, 255, (size, size, 4), np.uint8)
        ids.append(scene.textures.add_texture(mod.build_mip_chain(img), wrap=0, flags=flags))
    scene.add_material(mod.MaterialSettings(
        albedo_tex=ids[0], normal_tex=ids[1], metallic_roughness_tex=ids[2], emissive_tex=ids[3],
    ))
    return scene


def test_scene_to_torch_rejects_unported_scene():
    """The wide mq3 interleaved rows (Scene.matq3x3, off by default): on
    the hero (a plan with mq3_ok) scene_to_torch publishes (N, 208) rows
    and no tail pool, every table bit for bit against the reference's
    device_arrays() with matq3x3 set, and DeviceScene gives the same
    tables; a plan without mq3_ok keeps the 64 B rows and its tail pool,
    as the reference does."""
    from superconductor_tpu_torch.scene.upload import DeviceScene

    with open(HERO, "rb") as f:
        glb = f.read()
    ref, port = _scene_of(glb), _port_scene_of(glb)
    ref.matq3x3 = port.matq3x3 = True
    assert port.matq_plan()["mq3_ok"]
    tables = scene_to_torch(port, "cpu")
    assert tables["texels_mq"].shape == (port.matq_plan()["total_rows"], 208)
    assert "texels_mq_tail" not in tables
    _assert_same_tables(ref.device_arrays(), tables)
    _assert_same_tables(ref.device_arrays(), DeviceScene(port, "cpu").arrays())

    # 48^2 textures: the chain's 3 -> 1 step is not a clean halving
    ref, port = _material_scene(ref_scene_mod, 48), _material_scene(port_scene_mod, 48)
    ref.matq3x3 = port.matq3x3 = True
    assert port.matq_plan() is not None and not port.matq_plan()["mq3_ok"]
    tables = scene_to_torch(port, "cpu")
    assert tables["texels_mq"].shape[-1] == 64 and "texels_mq_tail" in tables
    _assert_same_tables(ref.device_arrays(), tables)

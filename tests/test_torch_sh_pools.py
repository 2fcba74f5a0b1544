"""The SH lookup on the SH-interleaved pools, as csrc/sh_sample.cuh computes
it for both shade kernels, and the wrappers' choice of form.

- ops/shade.py sample_spherical_harmonics on the lit scene's pools against
  the JAX package's at the edges the kernels must match: positions below
  and beyond the probe box, z below the first and above the last layer's
  centre, the negative texel edge (the fraction zeroed), exact texel
  centres; for the light volume alone, the lightmaps alone and both; on
  the particle shade's stand-in g-buffer (lm_uv 0, not lightmapped) and on
  a g-buffer whose lm_uv sits at the same edges, half its lanes
  lightmapped. Tolerance as tests/test_torch_lit.py states it: rtol 1e-5 /
  atol 1e-6 (XLA contracts the lerps into FMAs in process);
- PoolSH, the frame's sampler: called on positions it is the frame's old
  stand-in closure bit for bit, `sample` is the chain on a g-buffer, and
  shade_lanes_plain samples it as it samples a given SH;
- the wrappers' forms, with meta tensors and a stubbed launch: the
  particle shade one launch with the ambient SH or a pooled PoolSH (its
  pools in the launch's arguments), two with the layered path or a
  foreign sampler; the deferred shade one launch each, the pools in it or
  the torch SH (counted in shade.SAMPLED_SH); both raise on pools the
  kernels do not take.
"""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superconductor_tpu.ops import shade as ref_shade
from superconductor_tpu_torch.ops import particles as port_particles
from superconductor_tpu_torch.ops import shade as port_shade
from superconductor_tpu_torch.scenes import LIGHTVOL_DIMS
from test_torch_lit import _tables
from test_torch_particles_card import sh_sampler as stand_in_closure
from test_torch_particles_card import shade_case

torch.set_num_threads(2)

P = 2048
EDGES = ("below-box", "beyond-box", "z-below", "z-above", "negative-edge", "texel-centres")
WHICH = ("volume", "lightmaps", "both")


def _env(which: str):
    _r, _p, env, _u = _tables()
    if which == "volume":
        return dataclasses.replace(env, lightmap_tex_ids=None, lightmap_wh=None)
    if which == "lightmaps":
        return dataclasses.replace(env, lightvol_tex_ids=None, lightvol_wh=None)
    return env


def _edge_coords(edge: str, dims, seed: int, n: int = P) -> np.ndarray:
    """(n, len(dims)) normalised coordinates on a pool of `dims` texels
    (w, h[, z]) at an edge."""
    rng = np.random.default_rng(seed)
    d = np.asarray(dims, np.float64)
    c = rng.uniform(0.0, 1.0, size=(n, d.size))
    if edge == "below-box":
        c = rng.uniform(-1.0, -1e-3, size=c.shape)
    elif edge == "beyond-box":
        c = rng.uniform(1.0 + 1e-3, 2.0, size=c.shape)
    elif edge in ("z-below", "z-above") and d.size == 3:
        lo, hi = (0.0, 0.5 / d[2]) if edge == "z-below" else (1.0 - 0.5 / d[2], 1.0)
        c[:, 2] = rng.uniform(lo, hi, size=n)
    elif edge == "negative-edge":
        c[:, :2] = rng.uniform(-0.5, 0.5, size=(n, 2)) / d[:2]
    elif edge == "texel-centres":
        c = (rng.integers(0, d.astype(np.int64), size=c.shape) + 0.5) / d
    return c.astype(np.float32)


def _gbuffer(edge: str, form: str, seed: int = 3) -> dict:
    """world_pos, lm_uv and lightmapped (numpy) of P lanes at an edge: the
    stand-in's lm_uv 0 and no lane lightmapped, or ("mixed") lm_uv at the
    same edge of the lightmaps and half the lanes lightmapped."""
    _r, _p, env, u = _tables()
    box = _edge_coords(edge, LIGHTVOL_DIMS, seed)
    world = (u["probes_bottom_left"] + box * u["probes_scale"]).astype(np.float32)
    if form == "stand-in":
        return dict(world_pos=world, lm_uv=np.zeros((P, 2), np.float32),
                    lightmapped=np.zeros(P, bool))
    rng = np.random.default_rng(seed + 1)
    return dict(world_pos=world, lm_uv=_edge_coords(edge, env.lightmap_wh, seed + 2),
                lightmapped=rng.uniform(size=P) < 0.5)


def _sample(mod, fields: dict, tables: dict, uniforms: dict, env, to):
    g = {f: None for f in mod.GBuffer._fields}
    g.update({k: to(v) for k, v in fields.items()})
    return mod.sample_spherical_harmonics(mod.GBuffer(**g), tables,
                                          {k: to(v) for k, v in uniforms.items()}, env)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("form", ["stand-in", "mixed"])
@pytest.mark.parametrize("which", WHICH)
def test_pool_sh_at_the_edges_matches_reference(which, form, edge):
    """The port's chain on the interleaved pools against the JAX
    package's, the same lanes: rtol 1e-5 / atol 1e-6; the port's PoolSH
    gives the chain's values (its stand-in call on the stand-in lanes)."""
    dev_r, dev_p, _env_all, u = _tables()
    env = _env(which)
    g = _gbuffer(edge, form)
    ref = np.asarray(_sample(ref_shade, g, dev_r, u, env, jnp.asarray))
    port = _sample(port_shade, g, dev_p, u, env, _t)
    assert port.shape == (P, 4, 3) and torch.isfinite(port).all()
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-5, atol=1e-6)
    pool = port_shade.PoolSH(dev_p, {k: _t(v) for k, v in u.items()}, env)
    assert pool.pooled()
    if form == "stand-in":
        got = pool(_t(g["world_pos"]))
    else:
        gb = {f: None for f in port_shade.GBuffer._fields}
        gb.update({k: _t(v) for k, v in g.items()})
        got = pool.sample(port_shade.GBuffer(**gb))
    assert torch.equal(got.view(torch.int32), port.view(torch.int32))


@pytest.mark.parametrize("which", WHICH)
def test_pool_sh_is_the_frames_old_closure(which):
    """PoolSH called on positions equals the frame's old stand-in closure
    bit for bit, pooled or (its pools dropped: the layered path) not; the
    rows chip_smoke's bounds count for its taps lie inside the pools."""
    import chip_smoke

    _r, dev_p, _e, u = _tables()
    env = _env(which)
    u_p = {k: _t(v) for k, v in u.items()}
    pos = _t(_gbuffer("z-above", "stand-in")["world_pos"])
    for tables, pooled in ((dev_p, True),
                           ({k: v for k, v in dev_p.items() if k not in ("lv_sh", "lm_sh")},
                            False)):
        pool = port_shade.PoolSH(tables, u_p, env)
        assert pool.pooled() == pooled
        assert torch.equal(pool(pos), stand_in_closure(tables, u_p, env)(pos))
    rows = chip_smoke.sh_pool_rows(port_shade.PoolSH(dev_p, u_p, env), pos)
    assert len(rows) == {"volume": 2, "lightmaps": 1, "both": 3}[which]
    for table, idx in rows:  # the stand-in reads no lightmap row where the volume is bound
        assert idx.dtype == torch.int64
        assert idx.numel() == (0 if which == "both" and table is dev_p["lm_sh"] else P)
        assert idx.numel() == 0 or (int(idx.min()) >= 0 and int(idx.max()) < table.shape[0])


@pytest.mark.parametrize("which", WHICH)
def test_shade_lanes_plain_samples_a_pool_sh(which):
    """shade_inputs gives a PoolSH where a light volume or lightmaps are
    bound; shade_lanes_plain samples it on the g-buffer, as it would take
    the sampled tensor."""
    from test_torch_deferred_card import shade_args

    case = {"volume": "volume", "lightmaps": "lightmaps-only", "both": "lightmap"}[which]
    k = port_shade.shade_inputs(**shade_args(case, "cpu"))
    assert isinstance(k["sh"], port_shade.PoolSH) and k["sh"].pooled()
    calls = port_shade.sample_spherical_harmonics.CALLS
    rgb, alpha = port_shade.shade_lanes_plain(**k)
    assert port_shade.sample_spherical_harmonics.CALLS == calls + 1
    want_rgb, want_alpha = port_shade.shade_lanes_plain(**dict(k, sh=k["sh"].sample(k["gbuf"])))
    assert torch.equal(rgb, want_rgb) and torch.equal(alpha, want_alpha)


# --- the wrappers' forms, with meta tensors and a stubbed launch -----------------

def _meta(x):
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    if isinstance(x, dict):
        return {k: _meta(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_meta(v) for v in x])
    if isinstance(x, port_shade.PoolSH):
        return port_shade.PoolSH(_meta(x.scene), _meta(x.uniforms), x.env)
    return x


@contextlib.contextmanager
def _stubbed_launches(monkeypatch):
    """The wrappers past their device check, their launches recorded:
    [(symbol, arguments)]."""
    launches = []
    monkeypatch.setattr(port_shade, "_need_cuda", lambda fn, dev: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("Stream", (), {"cuda_stream": 0})())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(port_shade, "_check_pools_mirror", lambda: None)

    def particle_launch(fn, symbol, size_symbol, args, *size_args):
        launches.append((symbol, {f: getattr(args, f) for f, _ in type(args)._fields_}))

    def kernel_fn(symbol):
        return lambda *a: launches.append((symbol, a)) or 0

    monkeypatch.setattr(port_particles, "_launch", particle_launch)
    monkeypatch.setattr(port_shade, "_kernel_fn", kernel_fn)
    yield launches


def _particle_args(form: str) -> dict:
    sh = "ambient" if form == "ambient" else "both"
    args = _meta(shade_case("pool", sh, 64, "cpu"))
    if form == "foreign":
        args["sh_sampler"] = stand_in_closure(args["scene"], args["uniforms"], args["env"])
    elif form == "layered":
        scene = {k: v for k, v in args["scene"].items() if k not in ("lv_sh", "lm_sh")}
        args = dict(args, scene=scene,
                    sh_sampler=port_shade.PoolSH(scene, args["uniforms"], args["env"]))
    return args


FORMS = ("ambient", "pools", "layered", "foreign")


@pytest.mark.parametrize("form", FORMS)
def test_particle_shade_form_by_its_sampler(form, monkeypatch):
    """One launch with the ambient SH or a pooled PoolSH, the pools (light
    volume and lightmaps) in its arguments and no SH given; two (the
    position form, then the sampled SH) with the layered path or a foreign
    sampler."""
    args = _particle_args(form)
    assert port_particles.sh_form(args["env"], args["sh_sampler"]) == {
        "ambient": "ambient", "pools": "pools"}.get(form, "sampled")
    before = port_particles.shade_particles.LAUNCHES
    with _stubbed_launches(monkeypatch) as launches:
        port_particles.shade_particles(**args)
    n = 1 if form in ("ambient", "pools") else 2
    assert len(launches) == n and port_particles.shade_particles.LAUNCHES == before + n
    full = launches[-1][1]
    assert full["form"] == 0
    pools = full["pools"]  # (meta tensors have no address: the dims tell)
    assert (pools.lv_w > 0) == (pools.lm_w > 0) == (form == "pools")
    if form == "pools":
        assert (pools.lv_w, pools.lv_h, pools.lv_z) == LIGHTVOL_DIMS and pools.lm_w > 0
        assert full["sh"] is None
    if n == 2:
        assert launches[0][1]["form"] == 1


@pytest.mark.parametrize("form", FORMS)
def test_deferred_shade_form_by_its_sh(form, monkeypatch):
    """One launch each: the ambient values by value, the pools in place
    (no SH tensor, the lanes' lm_uv and lightmapped given), the layered
    path's torch SH (shade.SAMPLED_SH counts it), or a given SH tensor."""
    from test_torch_deferred_card import shade_args

    k = port_shade.shade_inputs(**shade_args("by-id" if form == "ambient" else "lightmap",
                                             "cpu"))
    if form == "layered":
        scene = {n: v for n, v in k["sh"].scene.items() if n not in ("lv_sh", "lm_sh")}
        k = dict(k, sh=port_shade.PoolSH(scene, k["sh"].uniforms, k["sh"].env))
    elif form == "foreign":
        k = dict(k, sh=k["sh"].sample(k["gbuf"]))
    k = {n: _meta(v) for n, v in k.items()}
    sampled = port_shade.shade.SAMPLED_SH
    with _stubbed_launches(monkeypatch) as launches:
        port_shade.shade_lanes(**k)
    (symbol, a), = launches
    assert symbol == "sc_shade"
    sh_ptr, pools, lm_uv, lightmapped = a[25], a[27], a[28], a[30]
    assert port_shade.shade.SAMPLED_SH == sampled + (form == "layered")
    assert (pools is not None) == (form == "pools")
    assert (sh_ptr is None) == (form in ("ambient", "pools"))
    if form == "pools":
        p = pools._obj
        assert p.lm_w > 0 and (p.lv_w, p.lv_h, p.lv_z) == LIGHTVOL_DIMS
        assert lm_uv is not None and lightmapped is not None


# pools and uniforms the kernels do not take
POOL_FAULTS = {
    "lv_sh float32": (lambda s, u, e: (dict(s, lv_sh=s["lv_sh"].float()), u, e), "lv_sh"),
    "lv_sh width 47": (lambda s, u, e: (dict(s, lv_sh=s["lv_sh"][:, :47]), u, e), "lv_sh"),
    "lm_sh float32": (lambda s, u, e: (dict(s, lm_sh=s["lm_sh"].float()), u, e), "lm_sh"),
    "lv_sh short of its dims": (lambda s, u, e: (dict(s, lv_sh=s["lv_sh"][:-1]), u, e),
                                "light volume"),
    "no z layers": (lambda s, u, e: (s, u, dataclasses.replace(e, lightvol_z_layers=0)),
                    "light volume"),
    "probes (1, 3)": (lambda s, u, e: (s, dict(u, probes_scale=u["probes_scale"][None]), e),
                      "probes_scale"),
}


@pytest.mark.parametrize("fault", sorted(POOL_FAULTS))
@pytest.mark.parametrize("wrapper", ["shade_particles", "shade_lanes"])
def test_wrappers_raise_on_pools_the_kernels_do_not_take(wrapper, fault, monkeypatch):
    make, word = POOL_FAULTS[fault]
    if wrapper == "shade_particles":
        args = _particle_args("pools")
        pool = args["sh_sampler"]
        args["sh_sampler"] = port_shade.PoolSH(*make(pool.scene, pool.uniforms, pool.env))
        call = port_particles.shade_particles
    else:
        from test_torch_deferred_card import shade_args

        args = {n: _meta(v) for n, v in port_shade.shade_inputs(
            **shade_args("lightmap", "cpu")).items()}
        pool = args["sh"]
        args["sh"] = port_shade.PoolSH(*make(pool.scene, pool.uniforms, pool.env))
        call = port_shade.shade_lanes
    assert args[{"shade_particles": "sh_sampler"}.get(wrapper, "sh")].pooled()
    with pytest.raises(ValueError, match=word):
        call(**args)
    with _stubbed_launches(monkeypatch), pytest.raises(ValueError, match=word):
        call(**args)

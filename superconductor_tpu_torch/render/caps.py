"""Never-drop capacity fitting for a scene (port of ``bench.py``
``fit_caps`` (:682-859) for the passes the port renders).

One stats frame per round, then grow any exceeded capacity, in
``bench.py``'s order: the bin-pair capacity ``p_cap`` (x2 to the next
power of two), the blend, clip and particle k-buffer depths
``blend_layers`` / ``clip_layers`` / ``particle_layers`` (to the next
power of two of the need); once nothing of those grows, ``p_cap``
tightens to ``size_worklist_cap(pairs_needed)``, and once that is settled
too each pass's K is pinned to its own need. Then the shared transparent
worklist ``shade_px_cap``, the opaque worklist ``opaque_px_cap`` (seeded
at DEFAULT_OPAQUE_PX_CAP) and the sky worklist ``sky_px_cap`` grow on
overflow; on a partial interleaved pool the material-path partition's
``matq_classic_cap`` engages (even at a need of 0) and grows on spill;
the sky worklist engages only when geometry covers at least half the
screen; and the blend / particle passes' per-layer worklists
``shade_px_caps`` are sized from their needs on first sight and grown on
overflow. As in ``bench.py`` (:825), the per-layer clip worklists
``clip_px_caps`` are never set here.
"""

from __future__ import annotations

from dataclasses import replace

from .draws import _next_pow2
from .frame import (
    DEFAULT_OPAQUE_PX_CAP,
    RenderConfig,
    render_frame_stats,
    size_worklist_cap,
    stats_to_host,
)


def _layer_growth(stats: dict, config: RenderConfig) -> dict:
    """Grow p_cap and the k-buffer depths; once none grows, tighten p_cap,
    then pin each pass's K to its need (bench.py:734-783)."""
    grow = {}
    if stats["pairs_needed"] > config.p_cap:
        grow["p_cap"] = _next_pow2(stats["pairs_needed"] * 2)
    blend_l, clip_l = stats["blend_layers_needed"], stats["clip_layers_needed"]
    part_l = stats["particle_layers_needed"]
    if blend_l > config.blend_layers:
        grow["blend_layers"] = _next_pow2(blend_l)
    if config.enable_clip and clip_l > config.resolve_clip_layers():
        grow["clip_layers"] = _next_pow2(clip_l)
    if config.enable_particles and part_l > config.resolve_particle_layers():
        grow["particle_layers"] = _next_pow2(part_l)
    if not grow:
        tight_p = size_worklist_cap(stats["pairs_needed"])
        if tight_p < config.p_cap:
            grow["p_cap"] = tight_p
    if not grow:
        new_blend = _next_pow2(max(blend_l, 1)) if config.enable_blend else config.blend_layers
        tighten_blend = new_blend < config.blend_layers
        if config.enable_clip and config.clip_layers is None:
            k = _next_pow2(max(clip_l, 1))
            if tighten_blend or k != config.blend_layers:
                grow["clip_layers"] = k
        if config.enable_particles and config.particle_layers is None:
            k = _next_pow2(max(part_l, 1))
            if tighten_blend or k != config.blend_layers:
                grow["particle_layers"] = k
        if tighten_blend and (
            not config.enable_clip or config.clip_layers is not None or "clip_layers" in grow
        ) and (
            not config.enable_particles or config.particle_layers is not None
            or "particle_layers" in grow
        ):
            grow["blend_layers"] = new_blend
    return grow


def fit_caps(dev: dict, state0, config: RenderConfig, env, max_rounds: int = 8,
             log=None) -> RenderConfig:
    """Right-size the never-drop capacities from stats frames; returns the
    (possibly grown) config. `log(stats, grow)` sees every round."""
    if config.opaque_px_cap is None:
        config = replace(config, opaque_px_cap=DEFAULT_OPAQUE_PX_CAP)
    for _ in range(max_rounds):
        _, stats = render_frame_stats(dev, state0, config, env)
        stats = stats_to_host(stats)
        grow = _layer_growth(stats, config)
        if stats["shade_px_needed"] > config.shade_px_cap:
            grow["shade_px_cap"] = size_worklist_cap(stats["shade_px_needed"])
        if (config.opaque_px_cap or 0) and config.opaque_px_cap < stats["opaque_px_needed"]:
            grow["opaque_px_cap"] = size_worklist_cap(stats["opaque_px_needed"])
        if (config.sky_px_cap or 0) and config.sky_px_cap < stats["sky_px_needed"]:
            grow["sky_px_cap"] = size_worklist_cap(stats["sky_px_needed"])
        mc_need = stats["matq_classic_needed"]
        if "matq_capable" in dev and (
            config.matq_classic_cap is None or config.matq_classic_cap < mc_need
        ):
            grow["matq_classic_cap"] = size_worklist_cap(mc_need)
        if config.sky_px_cap is None and not grow:
            sky_need = stats["sky_px_needed"]
            npx_band = config.width * (config.height // config.row_chunks)
            if 0 < sky_need < npx_band // 2:
                grow["sky_px_cap"] = size_worklist_cap(sky_need)
        nk = stats["shade_px_needed_k"]
        if nk and (config.enable_blend or config.enable_particles):
            if config.shade_px_caps is None:
                grow["shade_px_caps"] = tuple(size_worklist_cap(n) for n in nk)
            elif any(n > c for n, c in zip(nk, config.layer_caps())):
                grow["shade_px_caps"] = tuple(
                    max(c, size_worklist_cap(n)) for n, c in zip(nk, config.layer_caps())
                )
        if log is not None:
            log(stats, grow)
        if not grow:
            return config
        config = replace(config, **grow)
    return config

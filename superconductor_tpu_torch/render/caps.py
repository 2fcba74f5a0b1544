"""Never-drop capacity fitting for a scene (port of the part of
``bench.py`` ``fit_caps`` (:682-859) that the opaque frame exercises).

One stats frame per round, then grow any exceeded capacity: the bin-pair
capacity ``p_cap`` (grow x2 to the next power of two; once nothing grows,
tighten to ``size_worklist_cap(pairs_needed)``), the opaque shading
worklist ``opaque_px_cap`` (seeded at DEFAULT_OPAQUE_PX_CAP, grown by
``size_worklist_cap``), and the sky worklist ``sky_px_cap`` (engaged only
when geometry covers at least half the screen, grown on overflow). The
k-buffer, transparent-shading and material-partition caps belong to
passes outside the ported slice.
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


def fit_caps(dev: dict, state0, config: RenderConfig, env, max_rounds: int = 8,
             log=None) -> RenderConfig:
    """Right-size the never-drop capacities from stats frames; returns the
    (possibly grown) config. `log(stats, grow)` sees every round."""
    if config.opaque_px_cap is None:
        config = replace(config, opaque_px_cap=DEFAULT_OPAQUE_PX_CAP)
    for _ in range(max_rounds):
        _, stats = render_frame_stats(dev, state0, config, env)
        stats = stats_to_host(stats)
        grow = {}
        if stats["pairs_needed"] > config.p_cap:
            grow["p_cap"] = _next_pow2(stats["pairs_needed"] * 2)
        else:
            tight_p = size_worklist_cap(stats["pairs_needed"])
            if tight_p < config.p_cap:
                grow["p_cap"] = tight_p
        if (config.opaque_px_cap or 0) and config.opaque_px_cap < stats["opaque_px_needed"]:
            grow["opaque_px_cap"] = size_worklist_cap(stats["opaque_px_needed"])
        if (config.sky_px_cap or 0) and config.sky_px_cap < stats["sky_px_needed"]:
            grow["sky_px_cap"] = size_worklist_cap(stats["sky_px_needed"])
        if config.sky_px_cap is None and not grow:
            sky_need = stats["sky_px_needed"]
            npx_band = config.width * (config.height // config.row_chunks)
            if 0 < sky_need < npx_band // 2:
                grow["sky_px_cap"] = size_worklist_cap(sky_need)
        if log is not None:
            log(stats, grow)
        if not grow:
            return config
        config = replace(config, **grow)
    return config

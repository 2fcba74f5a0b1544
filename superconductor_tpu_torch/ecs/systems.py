"""Frame systems, mirroring src/systems.rs + systems/rendering.rs.

Stage layout (XrPlugin::build, src/lib.rs:84-171):
  AssetLoading:      start_loading_models, finish_loading_models,
                     update_ibl_resources, update_lightvol_textures,
                     add_joints_to_instances
  BufferResetting:   clear line/particle buffers, sample_animations,
                     update_uniforms
  InstanceBuffering: push_entity_instances (cull + LOD + draw rows),
                     push_joints
  BufferUploading:   (the scene's tables upload in render, through
                     DeviceScene.arrays(): only what changed; the frame's
                     own inputs are the FrameState construction)
  Rendering:         render (the frame function)

The port's copy of ``superconductor_tpu/ecs/systems.py``. Every system
and the growth and tighten rules of ``render`` are the reference's; what
differs is where the tables live and how stats reach the host:

  * ``render`` takes the scene's tables from ``DeviceScene.arrays()`` on
    ``RenderSettings.device`` (the reference's ``scene.device_arrays()``);
  * geometry capacities grow from the host-side draw counts that
    ``build_frame_state`` reports (``counts_out``), not from the draw
    tensors, so sizing reads nothing back from the card;
  * the steady-state stats check reads the previous frame's stats from
    an asynchronous copy to pinned host memory (``_HostStats``), waiting
    on that frame's CUDA event only;
  * with a ``utils.profiler.FrameProfiler`` resource in the world,
    ``render`` times its host phases under its scopes.

The decode job of ``start_loading_models`` runs on the fetch client's
executor and stays numpy-only; every torch call is on the frame thread.
"""

from __future__ import annotations

import contextlib
import logging
import math

import numpy as np
import torch

from ..assets.models import new_animation_joints
from ..render.camera import make_uniforms
from ..render.culling import sphere_culling_params
from ..render.draws import (
    _next_pow2,
    build_frame_state,
    pack_lines,
    pack_particles,
)
from ..render.env import EnvBindings
from ..render.frame import render_frame_stats, size_worklist_cap
from ..scene.upload import DeviceScene
from ..utils.profiler import FrameProfiler
from .app import App, Stage, World
from .components import (
    AnimatedModelUrl,
    Instance,
    InstanceOf,
    JointsComponent,
    ModelComponent,
    ModelUrl,
    PendingModel,
)
from .resources import (
    CameraResource,
    EventQueue,
    FrameOutput,
    FrameTiming,
    HttpClientResource,
    LineBuffer,
    NewIblCubemap,
    NewLightvolTextures,
    ParticleBuffer,
    RenderSettings,
    SceneResource,
)

log = logging.getLogger(__name__)


# --------------------------- AssetLoading ---------------------------------


def start_loading_models(world: World) -> None:
    """Kick off async loads for entities with a ModelUrl and no model yet
    (systems.rs:991-1110). Errors degrade, never crash (the reference's
    spawn wrapper logs and leaves dummies, renderer-core/src/lib.rs:248)."""
    scene = world.resource(SceneResource).scene
    client = world.resource(HttpClientResource).client

    res = world.resource(HttpClientResource)
    for ctype, animated in ((ModelUrl, False), (AnimatedModelUrl, True)):
        for entity, url in list(world.components.get(ctype, {}).items()):
            if world.get(entity, PendingModel) or world.get(entity, ModelComponent):
                continue

            def job(u=url.url, anim=animated,
                    mts=scene.max_texture_size,
                    defer=res.streamer is not None):
                data = client.fetch_bytes(u)
                # The whole DECODE runs here on the executor (GLB parse,
                # meshopt, image decode, mip chains) — the reference runs
                # all of Model::load on its executor (models.rs:280 via
                # spawn, renderer-core/src/lib.rs:248). Only scene
                # MUTATION stays on the frame thread (insert_model at
                # finish time), so a large model never hitches the
                # present loop. max_texture_size is captured at submit;
                # insert_model re-applies the scene's current value.
                from ..assets.models import decode_model

                return decode_model(
                    data, url=u, client=client, animated=anim,
                    max_texture_size=mts, defer_external=defer,
                ), anim, u

            world.insert(entity, PendingModel(client.submit(job)))


def finish_loading_models(world: World) -> None:
    """Swap finished loads into ModelComponent (systems.rs:1112-1123).
    The future holds a DecodedModel; only insert_model (mega-buffer +
    texture-pool copies) runs here on the frame thread."""
    from ..assets.models import insert_model

    scene = world.resource(SceneResource).scene
    res = world.resource(HttpClientResource)
    for entity, pending in list(world.components.get(PendingModel, {}).items()):
        if not pending.future.done():
            continue
        world.remove(entity, PendingModel)
        try:
            decoded, animated, url = pending.future.result()
            model = insert_model(
                scene, decoded, streamer=res.streamer
            )
            world.insert(entity, ModelComponent(model))
        except Exception:
            log.exception("model load failed; entity stays empty")


def pump_texture_streams(world: World) -> None:
    """Apply finished async texture decodes (the MutableBindGroup swap
    moment, texture_loading.rs:223-240)."""
    res = world.resource(HttpClientResource)
    if res.streamer is not None:
        res.streamer.pump(world.resource(SceneResource).scene)


def update_ibl_resources(world: World) -> None:
    """systems.rs:723: consume NewIblCubemap and load it."""
    res = world.get_resource(NewIblCubemap)
    if res is None:
        return
    scene = world.resource(SceneResource).scene
    client = world.resource(HttpClientResource).client
    try:
        from ..assets.environment import load_ibl_cubemap

        load_ibl_cubemap(scene, client.fetch_bytes(res.url))
        settings = world.resource(RenderSettings)
        settings.env = None  # rebuild bindings
    except Exception:
        log.exception("IBL cubemap load failed; keeping previous")
    world.resources.pop(NewIblCubemap, None)


def update_lightvol_textures(world: World) -> None:
    """systems.rs:593: consume NewLightvolTextures."""
    res = world.get_resource(NewLightvolTextures)
    if res is None:
        return
    scene = world.resource(SceneResource).scene
    client = world.resource(HttpClientResource).client
    try:
        from ..assets.environment import load_lightvol

        datas = [client.fetch_bytes(u) for u in res.urls]
        load_lightvol(
            scene, *datas, bottom_left=res.bottom_left, scale=res.scale
        )
        world.resource(RenderSettings).env = None
    except Exception:
        log.exception("lightvol load failed; keeping previous")
    world.resources.pop(NewLightvolTextures, None)


def add_joints_to_instances(world: World) -> None:
    """Give each instance of an animated model its own joint state
    (systems.rs:1135)."""
    for entity, _inst, of in list(world.query(Instance, InstanceOf)):
        if world.get(entity, JointsComponent) is not None:
            continue
        mc = world.get(of.model_entity, ModelComponent)
        if mc is None or not mc.model.animated:
            continue
        world.insert(
            entity, JointsComponent(joints=new_animation_joints(mc.model))
        )


# --------------------------- BufferResetting ------------------------------


def clear_frame_buffers(world: World) -> None:
    lines = world.get_resource(LineBuffer)
    if lines is not None:
        lines.clear()
    particles = world.get_resource(ParticleBuffer)
    if particles is not None:
        particles.clear()


def sample_animations(world: World) -> None:
    """systems.rs:109 -> Animation::animate + hierarchy update."""
    for entity, jc, of in world.query(JointsComponent, InstanceOf):
        mc = world.get(of.model_entity, ModelComponent)
        if mc is None or not mc.model.animations:
            continue
        anim = mc.model.animations[jc.animation_index % len(mc.model.animations)]
        anim.animate(jc.joints, jc.time)


def progress_animation_times(world: World) -> None:
    """Fixed 1/60 step, wraps at total_time (systems.rs:76-107)."""
    dt = world.resource(FrameTiming).delta
    for entity, jc, of in world.query(JointsComponent, InstanceOf):
        mc = world.get(of.model_entity, ModelComponent)
        if mc is None or not mc.model.animations:
            continue
        total = mc.model.animations[
            jc.animation_index % len(mc.model.animations)
        ].total_time
        jc.time += dt
        if total > 0 and jc.time > total:
            jc.time -= total


def push_joints(world: World) -> None:
    """Flatten joint hierarchies into per-instance palettes
    (systems.rs:141-202 + AnimationJoints::iter)."""
    for entity, jc, of in world.query(JointsComponent, InstanceOf):
        mc = world.get(of.model_entity, ModelComponent)
        if mc is None or mc.model.num_joints == 0:
            jc.palette = None
            continue
        jc.palette = jc.joints.joint_palette(
            mc.model.joint_node_indices,
            mc.model.inverse_bind8,
            mc.model.depth_first_nodes,
        )


# ------------------------ Instance building + render ----------------------


def _derive_config(config, scene, lines, particles):
    """Derive pass enables from scene content so materials never silently
    skip a pass (the reference renders every blend mode unconditionally,
    rendering.rs:506-558). Enables are monotonic: once on, they stay on, so
    the config (and with it the frame's shapes) doesn't flap as content
    churns."""
    from dataclasses import replace

    from ..scene.scene import BLEND_ALPHA_BLENDED, BLEND_ALPHA_CLIPPED

    modes = {m.blend_mode for m in scene.materials}
    want = {}
    if not config.enable_clip and BLEND_ALPHA_CLIPPED in modes:
        want["enable_clip"] = True
    if not config.enable_blend and BLEND_ALPHA_BLENDED in modes:
        want["enable_blend"] = True
    if not config.enable_lines and lines is not None and lines.segments:
        want["enable_lines"] = True
    if not config.enable_particles and particles is not None and particles.particles:
        want["enable_particles"] = True
    if want:
        log.info("enabling passes from scene content: %s", sorted(want))
        config = replace(config, **want)
    return config


def _grow_capacities(config, counts):
    """Grow triangle/vertex capacities to fit the frame's draw lists (exact
    host-side counts from build_frame_state's counts_out — expand_draws
    truncates at t_cap otherwise). Pow2 growth, mirroring the reference's
    never-drop buffer doubling (buffers.rs:61-106)."""
    from dataclasses import replace

    t_s, v_s = counts["tris_static"], counts["verts_static"]
    t_a, v_a = counts["tris_animated"], counts["verts_animated"]
    grow = {}
    if t_s > config.t_cap:
        grow["t_cap"] = _next_pow2(t_s)
    if v_s > (config.v_cap or config.t_cap):
        grow["v_cap"] = _next_pow2(v_s)
    if t_a > config.t_cap_anim:
        grow["t_cap_anim"] = _next_pow2(t_a)
    if v_a > (config.v_cap_anim or config.t_cap_anim):
        grow["v_cap_anim"] = _next_pow2(v_a)
    if grow:
        log.warning(
            "frame exceeds geometry capacity; growing %s (tris %d/%d static, "
            "%d/%d animated)", grow, t_s, config.t_cap, t_a, config.t_cap_anim,
        )
        config = replace(config, **grow)
    return config


class _HostStats:
    """A frame's stats dict on its way to the host: one asynchronous copy
    of every value into pinned memory, behind a CUDA event recorded after
    it. ``result()`` waits on that event only (not on frames submitted
    since) and returns what ``stats_to_host`` would. CPU stats are
    copied at once."""

    def __init__(self, stats: dict):
        self.shapes = [(k, tuple(v.shape)) for k, v in stats.items()]
        flat = torch.cat([v.reshape(-1).to(torch.int64) for v in stats.values()])
        self.event = None
        if flat.is_cuda:
            self.host = torch.empty(flat.shape, dtype=torch.int64, pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(flat.device))
        else:
            self.host = flat.clone()

    def result(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        vals = self.host.tolist()
        out, i = {}, 0
        for k, shape in self.shapes:
            n = math.prod(shape)
            out[k] = vals[i:i + n] if shape else vals[i]
            i += n
        return out


def device_arrays(world: World) -> dict:
    """The scene's tables on RenderSettings.device (the reference's
    scene.device_arrays()), kept resident by the SceneResource's
    DeviceScene."""
    scene_res = world.resource(SceneResource)
    device = torch.device(world.resource(RenderSettings).device)
    ds = scene_res.device_scene
    if ds is None or ds.scene is not scene_res.scene or ds.device != device:
        ds = scene_res.device_scene = DeviceScene(scene_res.scene, device)
    return ds.arrays()


def render(world: World) -> None:
    """InstanceBuffering + BufferUploading + Rendering in one system:
    collect visible instances, build the FrameState, call the frame.

    Separated host phases buy nothing here — build_frame_state already does
    culling/LOD (push_entity_instances) and array packing (upload_*).

    Robustness: pass enables are derived from scene content, geometry
    capacities are grown from exact host-side counts before the frame, and
    bin-pair overflow is detected from the frame's stats output and fixed by
    growing p_cap + re-rendering — nothing is ever silently dropped.
    """
    scene_res = world.resource(SceneResource)
    cam = world.resource(CameraResource)
    settings = world.resource(RenderSettings)
    config = settings.config
    prof = world.get_resource(FrameProfiler)

    def scope(name):
        return prof.scope(name) if prof is not None else contextlib.nullcontext()

    if config.num_views == 2:
        # Stereo: two eye views offset by the IPD, like the WebXR uniform
        # path (update_webxr_uniform_buffers, src/systems.rs:871-989).
        from ..render.stereo import stereo_uniforms_from_camera

        uniforms = stereo_uniforms_from_camera(
            cam.camera, config.width, config.height, ipd=cam.ipd,
            fov_y=cam.fov_y, z_near=cam.z_near, reverse_z=config.reverse_z,
        )
    else:
        uniforms = make_uniforms(
            cam.camera, config.width, config.height, cam.fov_y, cam.z_near,
            reverse_z=config.reverse_z,
        )
    scene = scene_res.scene
    if scene.lightvol is not None:
        uniforms.probes_bottom_left = np.asarray(
            scene.lightvol["bottom_left"], np.float32
        )
        uniforms.probes_scale = np.asarray(scene.lightvol["scale"], np.float32)

    instances = []
    palettes = {}
    for entity, inst, of in world.query(Instance, InstanceOf):
        mc = world.get(of.model_entity, ModelComponent)
        if mc is None:
            continue
        idx = len(instances)
        instances.append((mc.model, inst.similarity))
        jc = world.get(entity, JointsComponent)
        if jc is not None and jc.palette is not None:
            palettes[idx] = jc.palette

    # Per-eye culling params, unioned inside build_frame_state — an instance
    # visible to either eye is kept (CullingParams for VR, resources.rs:166-184).
    cull = [
        sphere_culling_params(uniforms.view_proj[v])
        for v in range(config.num_views)
    ]

    lines = world.get_resource(LineBuffer)
    particles = world.get_resource(ParticleBuffer)
    counts = {}
    with scope("build_frame_state"):
        state = build_frame_state(
            scene,
            instances,
            uniforms,
            joint_palettes=palettes,
            cull_params=cull,
            screen_height=config.height,
            lines=pack_lines(lines.segments, lines.colors) if lines else None,
            particles=pack_particles(particles.particles) if particles else None,
            device=settings.device,
            counts_out=counts,
        )

    config = _derive_config(config, scene, lines, particles)
    config = _grow_capacities(config, counts)
    if settings.stats_interval != 0 and config.opaque_px_cap is None:
        # Seed the compacted opaque-shading worklist only where the stats
        # loop below can grow it (never-drop); in zero-read mode
        # (stats_interval=0) the user pre-sizes caps explicitly and an
        # unseeded None keeps the always-correct full-screen shade.
        # (sky_px_cap is NOT seeded here — the sky worklist only wins on
        # high-coverage frames; the stats loop engages it from the
        # measured miss fraction instead.)
        from dataclasses import replace

        from ..render.frame import DEFAULT_OPAQUE_PX_CAP

        config = replace(config, opaque_px_cap=DEFAULT_OPAQUE_PX_CAP)
    settings.config = config

    if settings.env is None:
        settings.env = EnvBindings.from_scene(scene)

    with scope("upload"):
        arrays = device_arrays(world)
    out = world.resource(FrameOutput)
    out.state = state
    interval = settings.stats_interval
    if interval == 0:
        # Zero-read mode (see RenderSettings.stats_interval): the plain
        # stats-free executable, no device->host transfer on the frame
        # loop. Bin-pair / k-layer overflow detection is off.
        from ..render.frame import render_frame

        if out.last_config is None:
            log.warning(
                "stats_interval=0: bin-pair/k-layer overflow detection is "
                "OFF (size p_cap/blend_layers for the content up front)"
            )
        with scope("render_frame"):
            image = render_frame(arrays, state, config, settings.env)
        out.pending_stats = None
        out.last_config = config
        out.image = image
        out.frame_index += 1
        return

    with scope("render_frame"):
        image, stats = render_frame_stats(arrays, state, config, settings.env)
    host_stats = _HostStats(stats)
    # Bin-pair capacity check (pallas path; the ref path reports 0).
    # Fetching the in-flight frame's scalar would synchronize on frame
    # completion every frame, serializing host build with device render —
    # so sync only when the config just changed (first frame / scene or
    # resolution churn: exactly when overflow typically appears). In the
    # steady state, read the PREVIOUS frame's stats instead (every
    # `stats_interval`th frame): they are materialized by now, so the
    # check is cheap, and overflow grows p_cap/blend_layers up to
    # `stats_interval` frames late with a warning — never silently.
    check_stats = check_config = None
    if config != out.last_config or out.pending_stats is None:
        check_stats, check_config = host_stats, config
    elif out.frame_index % interval == 0:
        check_stats, check_config = out.pending_stats
    grow = {}
    tune = {}
    if check_stats is not None:
        with scope("stats_check"):
            check_stats = check_stats.result()
        pairs = check_stats["pairs_needed"]
        layers = check_stats["layers_needed"]
        shade_px = check_stats.get("shade_px_needed", 0)
        opaque_px = check_stats.get("opaque_px_needed", 0)
        if pairs > check_config.p_cap:
            grow["p_cap"] = _next_pow2(pairs * 2)
        # Per-pass k-buffer depths: a pixel needed more transparent layers
        # than that pass's k-buffer holds — a surface was dropped. Grow
        # that K (pow2) and re-render, restoring the reference's
        # draw-every-blended-fragment semantics (rendering.rs:550). Each
        # pass grows its own K so a deep particle stack doesn't make the
        # clip/blend kernels pay for it (and vice versa).
        blend_l = check_stats.get("blend_layers_needed", layers)
        clip_l = check_stats.get("clip_layers_needed", layers)
        part_l = check_stats.get("particle_layers_needed", layers)
        if blend_l > check_config.blend_layers:
            grow["blend_layers"] = _next_pow2(blend_l)
        if check_config.enable_clip and clip_l > check_config.resolve_clip_layers():
            grow["clip_layers"] = _next_pow2(clip_l)
        if (
            check_config.enable_particles
            and part_l > check_config.resolve_particle_layers()
        ):
            grow["particle_layers"] = _next_pow2(part_l)
        # First clean sighting: pin each transparent pass's K to its own
        # (often much shallower) need instead of the shared blend_layers —
        # pure perf, nothing dropped, applied next frame without a
        # re-render (same contract as the shade_px_caps tighten below).
        # blend_layers itself tightens only once clip/particles no longer
        # inherit it (pinned this round or already explicit).
        if not grow:
            new_blend = (
                _next_pow2(max(blend_l, 1))
                if check_config.enable_blend
                else check_config.blend_layers
            )
            tighten_blend = new_blend < check_config.blend_layers
            if check_config.enable_clip and check_config.clip_layers is None:
                k = _next_pow2(max(clip_l, 1))
                if tighten_blend or k != check_config.blend_layers:
                    tune["clip_layers"] = k
            if (
                check_config.enable_particles
                and check_config.particle_layers is None
            ):
                k = _next_pow2(max(part_l, 1))
                if tighten_blend or k != check_config.blend_layers:
                    tune["particle_layers"] = k
            if tighten_blend and (
                not check_config.enable_clip
                or check_config.clip_layers is not None
                or "clip_layers" in tune
            ) and (
                not check_config.enable_particles
                or check_config.particle_layers is not None
                or "particle_layers" in tune
            ):
                tune["blend_layers"] = new_blend
        if shade_px > check_config.shade_px_cap:
            # More pixels carried transparent fragments than the shading
            # worklist holds (render_view._compact_px) — some pixels'
            # clip/blend/particle layers went unshaded. Grow and
            # re-render (the cap self-limits at the band pixel count).
            grow["shade_px_cap"] = size_worklist_cap(shade_px)
        if (check_config.opaque_px_cap or 0) and (
            check_config.opaque_px_cap < opaque_px
        ):
            # Opaque/clip coverage exceeded the compacted shading worklist
            # — overflowed pixels showed sky. Grow and re-render; past the
            # band pixel count render_view statically falls back to the
            # full-screen shade, so growth self-limits.
            grow["opaque_px_cap"] = size_worklist_cap(opaque_px)
        sky_px = check_stats.get("sky_px_needed", 0)
        if (check_config.sky_px_cap or 0) and (
            check_config.sky_px_cap < sky_px
        ):
            # Miss coverage exceeded the sky worklist — overflowed sky
            # pixels rendered black. Same grow/re-render contract and
            # full-screen self-limit as opaque_px_cap.
            grow["sky_px_cap"] = size_worklist_cap(sky_px)
        mc_need = check_stats.get("matq_classic_needed", 0)
        if (
            check_config.matq_classic_cap is None
            and "matq_capable" in arrays
        ) or (check_config.matq_classic_cap or 0) < mc_need:
            # Partial interleaved pool: engage the material-path
            # partition (even at mc_need=0 — a floor-sized classic tail
            # is noise next to every capable lane dropping from ~9
            # classic gathers to 3 interleaved ones) and grow the tail
            # on spill. Growth is correctness (spilled incapable lanes
            # read the matq sentinel row); both go through grow so the
            # re-render validates the cap immediately.
            grow["matq_classic_cap"] = size_worklist_cap(mc_need)
        if check_config.sky_px_cap is None and not grow:
            # Engage the sky worklist only on high-coverage frames:
            # below ~50% geometry coverage, the compacted sky costs more
            # than the skipped lanes save (measured on the hero headline,
            # 82% sky: 43.2 vs 36.4 ms). Pure perf — applies next frame,
            # no re-render (nothing was dropped).
            npx_band = check_config.width * (
                check_config.height // max(check_config.row_chunks, 1)
            )
            if 0 < sky_px < npx_band // 2:
                tune["sky_px_cap"] = size_worklist_cap(sky_px)
        clip_k = check_stats.get("clip_px_needed_k")
        # DISABLED as in the reference (bench.fit_caps): its clip_px_caps
        # grower stays off, so the port's growers keep the shared-worklist
        # clip too.
        if False and clip_k and check_config.enable_clip:
            caps_ck = check_config.resolve_clip_caps()
            sized_ck = tuple(size_worklist_cap(n) for n in clip_k)
            if any(n > c for n, c in zip(clip_k, caps_ck)):
                # An overflowed resolve round lost clip surfaces on the
                # spilled pixels — grow and re-render (never-drop).
                if check_config.clip_px_caps is None:
                    grow["clip_px_caps"] = sized_ck
                else:
                    grow["clip_px_caps"] = tuple(
                        max(s, c) for s, c in zip(sized_ck, caps_ck)
                    )
            elif check_config.clip_px_caps is None:
                # First clean sighting: pin each resolve round to its own
                # need (pure perf, applies next frame, no re-render).
                tune["clip_px_caps"] = sized_ck
        needed_k = check_stats.get("shade_px_needed_k")
        if needed_k is not None and (
            check_config.enable_blend or check_config.enable_particles
        ):
            caps_k = check_config.layer_caps()
            sized = tuple(size_worklist_cap(n) for n in needed_k)
            if any(n > c for n, c in zip(needed_k, caps_k)):
                # A layer's worklist overflowed — those pixels lost that
                # transparent layer. Grow and re-render (never-drop).
                if check_config.shade_px_caps is None:
                    # First sighting, shared cap still in place: size every
                    # layer from its own need. Flooring at the old shared
                    # cap here would lock ALL K layers at >= the shared
                    # size and permanently skip the tighten branch —
                    # defeating the per-layer worklists exactly on the big
                    # scenes that overflow the default.
                    grow["shade_px_caps"] = sized
                else:
                    # Per-layer caps already set: grow only the overflowed
                    # layers, keep the rest.
                    grow["shade_px_caps"] = tuple(
                        max(s, c) for s, c in zip(sized, caps_k)
                    )
            elif check_config.shade_px_caps is None:
                # First stats sighting with the shared cap and no
                # overflow: tighten every layer's worklist to its own
                # (monotone-decreasing) need. Pure perf — nothing was
                # dropped this frame, so it applies from the next frame
                # with no re-render.
                tune["shade_px_caps"] = sized
    if grow:
        from dataclasses import replace

        log.warning(
            "frame capacity exceeded (bin pairs %d/%d, k-layers %d/%d, "
            "shade px %d/%d); growing %s and re-rendering",
            pairs, check_config.p_cap, layers, check_config.blend_layers,
            shade_px, check_config.shade_px_cap, grow,
        )
        config = replace(config, **grow)
        settings.config = config
        with scope("render_frame"):
            image, stats = render_frame_stats(arrays, state, config, settings.env)
        host_stats = _HostStats(stats)
    elif tune:
        from dataclasses import replace

        log.info("tightening per-layer shading worklists: %s", tune)
        # Takes effect next frame (config != last_config triggers the
        # synchronous stats check once, right after the recompile).
        settings.config = replace(config, **tune)
    out.pending_stats = (host_stats, config)
    out.last_config = config
    out.image = image
    out.frame_index += 1


class CorePlugin:
    """Registers the standard system schedule (the XrPlugin analog);
    frames render on `device`."""

    def __init__(self, config=None, client=None, device="cuda"):
        self.config = config
        self.client = client
        self.device = device

    def build(self, app: App) -> None:
        from ..render.frame import RenderConfig
        from ..scene.scene import Scene
        from ..assets.fetch import FileClient

        w = app.world
        scene = Scene()
        w.insert_resource(SceneResource(scene))
        w.insert_resource(CameraResource())
        w.insert_resource(
            RenderSettings(config=self.config or RenderConfig(), device=self.device)
        )
        http = HttpClientResource(self.client or FileClient())
        w.insert_resource(http)
        # Sync loads and the streamer share one texture-size cap.
        scene.max_texture_size = http.max_texture_size
        w.insert_resource(FrameOutput())
        w.insert_resource(FrameTiming())
        w.insert_resource(LineBuffer())
        w.insert_resource(ParticleBuffer())
        w.insert_resource(EventQueue())

        app.add_system(Stage.ASSET_LOADING, start_loading_models)
        app.add_system(Stage.ASSET_LOADING, finish_loading_models)
        app.add_system(Stage.ASSET_LOADING, pump_texture_streams)
        app.add_system(Stage.ASSET_LOADING, update_ibl_resources)
        app.add_system(Stage.ASSET_LOADING, update_lightvol_textures)
        app.add_system(Stage.ASSET_LOADING, add_joints_to_instances)
        app.add_system(Stage.BUFFER_RESETTING, clear_frame_buffers)
        app.add_system(Stage.BUFFER_RESETTING, sample_animations)
        app.add_system(Stage.INSTANCE_BUFFERING, push_joints)
        app.add_system(Stage.BUFFER_UPLOADING, progress_animation_times)
        app.add_system(Stage.RENDERING, render)

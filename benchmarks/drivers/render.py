"""Driver ``render``: one client asking for novel views of a fused map, in a
closed loop, as ``load_map`` renders them.

Set-up makes the traffic's drive on the device, fuses its first
``map.frames`` frames through the program's mapper (the map the views look
at), takes the mapper's compacted map and warms the renderer on views of
their own stream.  Each view of the window goes through
``render_view(method="fast")`` with the previous view's active block count
fed forward as its cull budget, and is delivered when its RGB and semantic
images are u8 arrays in host memory, as ``load_map`` writes them.
``views_per_s`` is the views over the window's seconds, ``view_ms_p95`` the
95th percentile of every view's latency, from the ``render_view`` call to
delivery.

Besides the views of the window, the check renders ``start_views`` views
of the drive's first frames from the reference's own map of them: the
program's renderer and the reference's draw the same map, which nothing of
the program made.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmarks import mapping
from benchmarks.harness import HERE, Tracer, load_module


@dataclasses.dataclass
class State:
    drive: object
    mapper: object
    tap: mapping.WindowTap
    cam: object
    smap: object
    views: object
    hint: int | None
    check_ids: set
    kept: dict = dataclasses.field(default_factory=dict)


def stage_targets():
    """Ranges for the traced run: the call into the renderer and its stages
    (cull, centres, K1, dilation, decode) and the delivery."""
    from surfelmapping_tpu_torch import views
    from surfelmapping_tpu_torch.ops import splat

    return [(splat, {"render_view": "render_view", "cull_for_render": "cull",
                     "fast_candidates": "centres", "zbuffer_argmin_packed": "k1",
                     "_dilate": "dilation", "_decode": "decode"}),
            (views, {"render_u8": "to_u8"})]


def render(st: State, ctx, view: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One view as ``load_map`` renders it: RGB and semantic u8 on the host."""
    from surfelmapping_tpu_torch import views
    from surfelmapping_tpu_torch.ops import splat

    out = splat.render_view(st.smap, view, st.cam, footprint=ctx.cell.traffic["footprint"],
                            start_blocks=st.hint, device=ctx.device)
    st.hint = int(out["n_active_blocks"]) + 1
    rgb, sem = views.render_u8(out)
    return rgb.cpu().numpy(), sem.cpu().numpy()


def setup(ctx) -> State:
    from surfelmapping_tpu_torch.config import CameraIntrinsics

    cell, mix = ctx.cell, ctx.cell.traffic
    drv = mix["map"]
    t_gen = time.perf_counter()
    drive = load_module(HERE / "traffic" / f"{drv['generator']}.py").Drive(
        cell.config, drv, ctx.seed, ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    t_fuse = time.perf_counter()
    ctx.notes["generate_s"] = t_fuse - t_gen
    mapper = mapping.program_mapper(cell.config, ctx.device)
    tap = mapping.WindowTap(mapper, seed=ctx.seed, collect=True)
    for t in range(drv["frames"]):
        mapper.process_frame(*drive.frame(t))
        tap.after_frame(t)
    smap = mapper.smap  # syncs and compacts, as save_map does before load_map reads it
    tap.close()
    ctx.notes["map_s"] = time.perf_counter() - t_fuse
    gen = cell.generator()
    base = [drive.pose(t) for t in range(drv["frames"])]
    rng = np.random.default_rng([ctx.seed, 2])
    st = State(drive, mapper, tap, CameraIntrinsics(**cell.config["camera"]), smap,
               gen.NovelViews(base, mix, ctx.seed), None,
               set(int(i) for i in rng.choice(mix["check_within"], mix["check_views"],
                                              replace=False)))
    warm = gen.NovelViews(base, mix, ctx.seed, stream=1)
    for _ in range(mix["warm_views"]):
        render(st, ctx, warm.next())
    return st


def window(st: State, ctx) -> dict:
    mix = ctx.cell.traffic
    tracer = Tracer(mix["trace_views"], stage_targets()) if ctx.trace else None
    trace_at = mix["trace_after_views"]
    lat: list[float] = []
    slowest = (-1.0, None)

    def one():
        nonlocal slowest
        view = st.views.next()
        t = time.perf_counter()
        rgb, sem = render(st, ctx, view)
        dt = time.perf_counter() - t
        i = len(lat)
        lat.append(dt)
        if i in st.check_ids:
            st.kept[i] = (view, rgb, sem)
        if dt > slowest[0]:
            slowest = (dt, (view, rgb, sem))

    t0 = time.perf_counter()
    ctx.window_started(t0)
    while True:
        if tracer is not None and not tracer.done and len(lat) >= trace_at:
            with tracer.stretch():
                for _ in range(tracer.items):
                    one()
        else:
            one()
        if time.perf_counter() - t0 >= ctx.seconds and (tracer is None or tracer.done):
            break
    seconds = time.perf_counter() - t0
    st.kept["slowest"] = slowest[1]
    return {"attempted": len(lat), "failed": 0, "seconds": seconds,
            "metrics": {"views_per_s": len(lat) / seconds,
                        "view_ms_p95": float(np.percentile(np.asarray(lat) * 1e3, 95))},
            "records": None if tracer is None else tracer.records,
            "live_surfels": int(st.smap.count)}


def check(st: State, ctx) -> dict:
    """Frees the program's mapper, then holds the set-up's fusion and the
    kept views to the reference: {name: (value, limit)}."""
    from surfelmapping_tpu_torch import views
    from surfelmapping_tpu_torch.ops import splat

    from benchmarks.reference.mapping.splat import render_u8

    st.mapper = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    found, notes = mapping.check_fusion(st.tap, st.drive.frame, ctx.cell.config, ctx.device,
                                        ctx.control, keep_start=True)
    ctx.notes["checked_windows"] = notes["checked_windows"]
    cam, _, _ = mapping.reference_settings(ctx.cell.config)
    footprint = ctx.cell.traffic["footprint"]

    def bfloat16_positions(smap):
        held = mapping.as_reference(smap, clone=True)
        for k in ("px", "py", "pz"):
            col = getattr(held, k)
            col.copy_(col.to(torch.bfloat16).to(torch.float32))
        return held

    def differ(ref_map, ctl_map, kept) -> int:
        pixels = 0
        for view, rgb, sem in kept:
            v = torch.as_tensor(view, device=ctx.device)
            want_rgb, want_sem = render_u8(ref_map, v, cam, footprint=footprint)
            if ctl_map is not None:
                got = render_u8(ctl_map, v, cam, footprint=footprint)
                rgb, sem = got[0].cpu().numpy(), got[1].cpu().numpy()
            bad = (want_rgb.cpu().numpy() != rgb).any(axis=-1) | (want_sem.cpu().numpy() != sem)
            pixels += int(bad.sum())
        return pixels

    found["pixel_mismatch"] = differ(
        mapping.as_reference(st.smap), bfloat16_positions(st.smap) if ctx.control else None,
        st.kept.values())
    # views of the reference's own map of the first frames, drawn by the
    # program's renderer
    ref_start = notes["start_map"]
    gen = ctx.cell.generator()
    base = [st.drive.pose(t) for t in range(st.tap.first_end)]
    stream = gen.NovelViews(base, ctx.cell.traffic, ctx.seed, stream=2)
    kept = []
    for _ in range(ctx.cell.traffic["start_views"]):
        view = stream.next()
        out = splat.render_view(mapping.as_program(ref_start), view, st.cam,
                                footprint=footprint, device=ctx.device)
        rgb, sem = views.render_u8(out)
        kept.append((view, rgb.cpu().numpy(), sem.cpu().numpy()))
    found["start_pixel_mismatch"] = differ(
        ref_start, bfloat16_positions(ref_start) if ctx.control else None, kept)
    return {k: (v, ctx.cell.settings["limits"][k]) for k, v in found.items()}

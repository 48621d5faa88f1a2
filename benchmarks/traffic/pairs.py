"""Generator ``pairs``: paired training views for SPADE, made as LADS makes
them, by the program's own mapping and rendering: a drive of the mapping
configuration (``traffic/drive.py``), fused through the program's mapper,
then each frame's own pose rendered from the whole map with
``ops/splat.render_view`` and ``views.render_u8`` (the label: the render's
RGB) beside the drive's camera image of that frame (the photo).  The pairs
are written once as PNGs, ``label/NNNNNN.png`` and ``image/NNNNNN.png``,
which ``models.data.PairedRenderDataset`` reads as ``spade_train`` does.

The mix's ``map`` names the mapping configuration (a file under
``configs/``, or the configuration itself) and the drive's settings.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import torch
from PIL import Image

from benchmarks import mapping
from benchmarks.harness import HERE, load_json, load_module

PNG_LEVEL = 1  # zlib level: the pairs are written once, read many times


def map_config(mix: dict) -> dict:
    cfg = mix["map"]["config"]
    return load_json(HERE / "configs" / f"{cfg}.json") if isinstance(cfg, str) else cfg


def write_pairs(mix: dict, seed: int, device, out: str) -> dict:
    """Write the mix's pairs under ``out``; returns where they are and the
    seconds of each part."""
    import time

    from surfelmapping_tpu_torch import views
    from surfelmapping_tpu_torch.config import CameraIntrinsics
    from surfelmapping_tpu_torch.ops import splat

    cfg, drv = map_config(mix), mix["map"]
    t0 = time.perf_counter()
    drive = load_module(HERE / "traffic" / "drive.py").Drive(cfg, drv, seed, device)
    mapper = mapping.program_mapper(cfg, device)
    frames = int(drv["frames"])
    for t in range(frames):
        mapper.process_frame(*drive.frame(t))
    smap = mapper.smap  # synced and compacted, as load_map reads a saved map
    t1 = time.perf_counter()
    dirs = {k: os.path.join(out, k) for k in ("label", "image")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    cam = CameraIntrinsics(**cfg["camera"])
    hint = None
    with ThreadPoolExecutor(8) as pool:
        writes = []
        for t in range(frames):
            r = splat.render_view(smap, drive.pose(t), cam, footprint=mix["footprint"],
                                  start_blocks=hint, device=device)
            hint = int(r["n_active_blocks"]) + 1
            label = views.render_u8(r)[0].cpu().numpy()
            photo = drive.rgb[t % drive.period].cpu().numpy()
            name = f"{t:06d}.png"
            for key, arr in (("label", label), ("image", photo)):
                writes.append(pool.submit(Image.fromarray(arr).save,
                                          os.path.join(dirs[key], name), compress_level=PNG_LEVEL))
        for w in writes:
            w.result()
    live = int(smap.count)
    del mapper, smap, drive
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"label_dir": dirs["label"], "image_dir": dirs["image"], "frames": frames,
            "live_surfels": live, "map_s": t1 - t0, "render_write_s": time.perf_counter() - t1}

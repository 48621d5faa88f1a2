"""End-to-end simulator data-flow chain through the port's CLIs (the
counterpart of the root tools/run_e2e.py), checking the artifacts at every
hop:

  build_map (synthetic frames, reference-format map)
    -> load_map --mode paired / random / s / overview  (render PNG pairs)
    -> spade_train (tiny GAN, a few steps, on paired render vs captured)
    -> spade_test (enhance the novel renders, postprocess composite)
    -> move_data (renumber into the final dataset layout)

Writes ``e2e.json``, the per-hop inventory, into the work directory and
prints it; a temporary work directory (no ``--workdir``) is removed at the
end.  Runs on the CUDA card unless ``--device cpu`` is given.

Usage: python -m surfelmapping_tpu_torch.tools.run_e2e [--workdir DIR]
           [--frames 6] [--synthetic-cam kitti|small] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import struct
import sys
import tempfile

import numpy as np

# build_map's map holds at least this share of one frame's pixels: 50,000
# surfels at KITTI's 1226x370, as the root tools/run_e2e.py requires there
MIN_SURFELS_PER_PIXEL = 50_000 / (1226 * 370)


def count_pngs(d: str) -> int:
    if not os.path.isdir(d):
        return -1
    return len([f for f in os.listdir(d) if f.endswith(".png")])


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"run_e2e: {what}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--synthetic-cam", choices=["kitti", "small"], default="kitti")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from PIL import Image

    from .. import build_map, load_map, move_data, spade_test, spade_train
    from ..io.synthetic import SyntheticScene, kitti_cam, tiny_cam
    from ..pipeline import resolve_device

    dev = ["--device", str(resolve_device(args.device))]
    cam_flag = ["--synthetic-cam", args.synthetic_cam]
    cam = tiny_cam(256, 128) if args.synthetic_cam == "small" else kitti_cam()
    wd = args.workdir or tempfile.mkdtemp(prefix="smtpu_torch_e2e_")
    os.makedirs(wd, exist_ok=True)
    doc = {"workdir": wd, "device": dev[1], "hops": {}}
    F = args.frames

    # ---- hop 1: build + save the map ------------------------------------
    map_path = os.path.join(wd, "map.bin")
    rc = build_map.main(["--synthetic", str(F), "--out", map_path, "--capacity", str(1 << 20),
                         "--fuse-thresh", "0.05"] + cam_flag + dev)
    require(rc == 0 and os.path.exists(map_path), "build_map failed")
    with open(map_path, "rb") as f:
        n_surfels, start_id, end_id = struct.unpack("<Iii", f.read(12))
    require(n_surfels > MIN_SURFELS_PER_PIXEL * cam.width * cam.height,
            f"implausibly small map: {n_surfels}")
    doc["hops"]["build_map"] = {"surfels": n_surfels, "start_id": start_id,
                                "end_id": end_id, "bytes": os.path.getsize(map_path)}

    # ---- hop 2: the four load_map simulation paths ----------------------
    expected = {}
    for mode in ("paired", "random", "s", "overview"):
        out_dir = os.path.join(wd, f"novel_{mode}")
        rc = load_map.main([map_path, "--synthetic", "--mode", mode, "--num", "3",
                            "--out", out_dir, "--footprint", "4"] + cam_flag + dev)
        require(rc == 0, f"load_map --mode {mode} failed")
        actual_dir = (out_dir.replace("novel", "paired") if mode == "paired"
                      else out_dir.replace("novel", "overview") if mode == "overview"
                      else out_dir)
        n_img = count_pngs(os.path.join(actual_dir, "image"))
        n_sem = count_pngs(os.path.join(actual_dir, "semantic"))
        require(n_img == n_sem and n_img > 0, f"{mode}: {n_img} vs {n_sem}")
        # format checks: RGB u8 image; semantic u8 with 0 = hole
        name = sorted(os.listdir(os.path.join(actual_dir, "image")))[0]
        im = np.asarray(Image.open(os.path.join(actual_dir, "image", name)))
        sm = np.asarray(Image.open(os.path.join(actual_dir, "semantic", name)))
        require(im.ndim == 3 and im.shape[2] == 3 and im.dtype == np.uint8,
                f"{mode}: image {im.shape} {im.dtype}")
        require(sm.ndim == 2 and sm.max() >= 1, f"{mode}: semantic all holes")
        expected[mode] = actual_dir
        doc["hops"][f"load_map_{mode}"] = {
            "pairs": n_img, "dir": actual_dir,
            "image_nonzero_frac": round(float((im > 0).any(-1).mean()), 3),
        }

    # ---- hop 3: captured 'real' images for GAN training ------------------
    real_dir = os.path.join(wd, "captured", "image")
    os.makedirs(real_dir, exist_ok=True)
    scene = SyntheticScene(cam)
    for i in range(F):
        Image.fromarray(np.asarray(scene.frame(i)[0], np.uint8)).save(
            os.path.join(real_dir, f"{i:06d}.png"))

    # ---- hop 4: SPADE training on (rendered label, captured real) -------
    ckpt = os.path.join(wd, "ckpt")
    rc = spade_train.main([
        "--label-dir", os.path.join(expected["paired"], "image"), "--image-dir", real_dir,
        "--niter", "1", "--niter-decay", "0", "--steps-per-epoch", "2",
        "--crop", "32", "--ngf", "8", "--ndf", "8", "--num-d", "1", "--n-layers-d", "2",
        "--no-vgg", "--ckpt-dir", ckpt, "--log-every", "1", "--display-every", "1000",
    ] + dev)
    require(rc == 0 and os.path.exists(os.path.join(ckpt, "latest.msgpack")),
            "spade_train wrote no checkpoint")
    doc["hops"]["spade_train"] = {"ckpt_files": sorted(os.listdir(ckpt))[:8]}

    # ---- hop 5: enhancement of the novel renders ------------------------
    enhanced = os.path.join(wd, "enhanced")
    rc = spade_test.main([
        "--ckpt", os.path.join(ckpt, "latest.msgpack"),
        "--label-dir", os.path.join(expected["random"], "image"),
        "--semantic-dir", os.path.join(expected["random"], "semantic"),
        "--out", enhanced, "--ngf", "8", "--num-d", "1", "--n-layers-d", "2",
    ] + dev)
    require(rc == 0, "spade_test failed")
    n_enh = count_pngs(enhanced)
    require(n_enh == count_pngs(os.path.join(expected["random"], "image")),
            f"{n_enh} enhanced images")
    doc["hops"]["spade_test"] = {"enhanced": n_enh}

    # ---- hop 6: renumber into the final dataset -------------------------
    final = os.path.join(wd, "dataset")
    rc = move_data.main(["--offset", str(1000), "-t", final, "-s", expected["random"]])
    require(rc == 0, "move_data failed")
    names = sorted(os.listdir(os.path.join(final, "image")))
    require(names[0] == "001000.png", f"move_data named {names[:2]}")
    doc["hops"]["move_data"] = {"moved": len(names), "first": names[0]}

    doc["ok"] = True
    with open(os.path.join(wd, "e2e.json"), "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc))
    if args.workdir is None:
        shutil.rmtree(wd, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""KITTI-layout dataset reader (counterpart of surfelmapping_tpu/io/kitti.py,
reference gui/KittiReader.{h,cpp}), and its writer.

Directory layout (gui/KittiReader.cpp:27-44):
    <dir>/times.txt         one float per frame
    <dir>/calibration.txt   line 1: "fx fy cx cy", line 2: "width height"
    <dir>/pose.txt          3x4 row-major ground-truth poses (cam0 frame)
    <dir>/image_2/NNNNNN.png    RGB
    <dir>/PSMNet/NNNNNN.png     uint16 depth in mm
    <dir>/semantics/NNNNNN.png  uint8 class labels

Reproduced behaviours:
  * poses are right-multiplied by the fixed stereo-baseline correction
    T20 = translate(x: -0.06) (gui/KittiReader.cpp:290-298);
  * file names are zero-padded 6-digit ids (gui/KittiReader.cpp:63-70);
  * ``sub_level`` L takes every 2**L-th pixel and divides the intrinsics by
    2**L (the JAX package's documented divergence from the reference's
    single halving, gui/KittiReader.cpp:248-259);
  * getNext/getLast/saveState/resumeState frame-cursor semantics
    (gui/DatasetReader.cpp:86-99).

The decoder is the caller's choice and is never swapped behind its back:
``decoder="native"`` decodes with the port's libpng library
(io/native.py: a prefetcher on background threads for sequential reads,
its single-image decoder otherwise), and raises if that library cannot be
built, loaded or decode a frame; ``decoder="pil"`` decodes with PIL.  The
library is built at the first frame read, so a reader used only for its
calibration and poses never needs it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
from PIL import Image

from ..config import CameraIntrinsics

DECODERS = ("native", "pil")


@dataclass
class Frame:
    frame_id: int
    time: float
    rgb: np.ndarray       # u8[H,W,3]
    depth: np.ndarray     # u16[H,W] mm
    semantic: np.ndarray  # u8[H,W]
    pose: np.ndarray      # f32[4,4] camera-to-world (gt, baseline-corrected)


# stereo-baseline correction applied to every gt pose
# (gui/KittiReader.cpp:290-298)
T20 = np.array(
    [[1, 0, 0, -0.06], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float32
)


def _name(idx: int) -> str:
    return f"{idx:06d}.png"


class KittiReader:
    def __init__(self, dataset_dir: str, sub_level: int = 0, decoder: str = "native"):
        if decoder not in DECODERS:
            raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")
        self.dir = dataset_dir
        self.sub_level = sub_level
        self.decoder = decoder
        self.times = self._load_times()
        self.cam = self._load_calibration()
        self.poses = self._load_ground_truth()
        self.current = -1
        self._saved = -1
        self._prefetcher = None
        self._pf_next = None  # the prefetcher's next frame, from the first read on

    # -- loading ----------------------------------------------------------

    def _load_times(self) -> list[float]:
        with open(os.path.join(self.dir, "times.txt")) as f:
            return [float(line.strip()) for line in f if line.strip()]

    def _load_calibration(self) -> CameraIntrinsics:
        with open(os.path.join(self.dir, "calibration.txt")) as f:
            fx, fy, cx, cy = map(float, f.readline().split()[:4])
            w, h = map(int, f.readline().split()[:2])
        s = 1 << self.sub_level
        if self.sub_level:
            fx, fy, cx, cy = fx / s, fy / s, cx / s, cy / s
            w, h = w >> self.sub_level, h >> self.sub_level
        return CameraIntrinsics(fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h)

    def _load_ground_truth(self) -> np.ndarray:
        poses = []
        with open(os.path.join(self.dir, "pose.txt")) as f:
            for line in f:
                vals = [float(x) for x in line.split()]
                if len(vals) < 12:
                    continue
                T = np.eye(4, dtype=np.float32)
                T[:3, :4] = np.asarray(vals[:12], np.float32).reshape(3, 4)
                poses.append(T @ T20)
        if len(poses) != len(self.times):
            raise ValueError(f"{self.dir}: {len(poses)} poses for {len(self.times)} times")
        return np.stack(poses)

    # -- frame access -----------------------------------------------------

    def __len__(self) -> int:
        return len(self.times)

    def _path(self, sub: str, idx: int) -> str:
        return os.path.join(self.dir, sub, _name(idx))

    def _decode(self, idx: int):
        if self.decoder == "pil":
            return (np.array(Image.open(self._path("image_2", idx)).convert("RGB")),
                    np.array(Image.open(self._path("PSMNet", idx))).astype(np.uint16),
                    np.array(Image.open(self._path("semantics", idx)).convert("L")))
        from . import native

        if self._pf_next is None:
            self._prefetcher = native.FramePrefetcher(
                os.path.join(self.dir, "image_2"), os.path.join(self.dir, "PSMNet"),
                os.path.join(self.dir, "semantics"), idx, len(self) - 1)
            self._pf_next = idx
        # the prefetcher decodes strictly forward: sequential reads take its
        # frames, random/backward access (the cleanPoints replay) decodes here
        if idx == self._pf_next:
            self._pf_next = idx + 1
            return self._prefetcher.get(idx)
        return (native.read_png(self._path("image_2", idx)),
                native.read_png(self._path("PSMNet", idx)).astype(np.uint16),
                native.read_png(self._path("semantics", idx)))

    def _load(self, idx: int) -> Frame:
        rgb, depth, sem = self._decode(idx)
        if self.sub_level:
            s = 1 << self.sub_level
            rgb, depth, sem = rgb[::s, ::s], depth[::s, ::s], sem[::s, ::s]
        H, W = self.cam.height, self.cam.width
        return Frame(frame_id=idx, time=self.times[idx], rgb=rgb[:H, :W],
                     depth=depth[:H, :W], semantic=sem[:H, :W], pose=self.poses[idx])

    def get_next(self) -> Frame | None:
        """Advance and return the next frame (DatasetReader::getNext)."""
        if self.current + 1 >= len(self):
            return None
        self.current += 1
        return self._load(self.current)

    def get_last(self) -> Frame | None:
        """Step backwards (DatasetReader::getLast), as the cleanPoints replay
        loop does (build_map.cpp:306-326)."""
        if self.current - 1 < 0:
            return None
        self.current -= 1
        return self._load(self.current)

    def save_state(self) -> None:
        self._saved = self.current

    def resume_state(self) -> None:
        self.current = self._saved

    def set_state(self, frame_id: int) -> None:
        self.current = frame_id

    def close(self) -> None:
        """Stop the native prefetcher's threads (if one was started)."""
        if self._prefetcher is not None:
            self._prefetcher.close()


def write_kitti_dir(path: str, cam: CameraIntrinsics, frames) -> int:
    """Write ``frames`` — (rgb u8[H,W,3], depth u16[H,W] mm, semantic
    u8[H,W], camera-to-world pose f32[4,4]) tuples — as a KITTI-layout
    directory that :class:`KittiReader` reads back: the images as PNGs (u16
    depth losslessly), times 0.1 s apart, ``cam`` as calibration.txt and
    each pose as ``pose @ inv(T20)``, so the reader's ``T @ T20`` returns
    it up to float32 rounding.  Returns the number of frames written."""
    for sub in ("image_2", "PSMNet", "semantics"):
        os.makedirs(os.path.join(path, sub), exist_ok=True)
    t20_inv = np.linalg.inv(T20.astype(np.float64))
    lines = []
    n = 0
    for i, (rgb, depth, sem, pose) in enumerate(frames):
        Image.fromarray(np.asarray(rgb, np.uint8)).save(os.path.join(path, "image_2", _name(i)))
        Image.fromarray(np.asarray(depth, np.uint16)).save(os.path.join(path, "PSMNet", _name(i)))
        Image.fromarray(np.asarray(sem, np.uint8)).save(os.path.join(path, "semantics", _name(i)))
        T = np.asarray(pose, np.float64) @ t20_inv
        lines.append(" ".join(repr(float(x)) for x in T[:3].ravel()) + "\n")
        n += 1
    with open(os.path.join(path, "pose.txt"), "w") as f:
        f.writelines(lines)
    with open(os.path.join(path, "times.txt"), "w") as f:
        f.writelines(f"{i * 0.1:.6f}\n" for i in range(n))
    with open(os.path.join(path, "calibration.txt"), "w") as f:
        f.write(f"{cam.fx!r} {cam.fy!r} {cam.cx!r} {cam.cy!r}\n{cam.width} {cam.height}\n")
    return n

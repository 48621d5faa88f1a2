"""Static configuration of the PyTorch surfel mapping engine.

A copy of ``surfelmapping_tpu/config.py`` (the port imports nothing of the
JAX package): frozen, hashable dataclasses holding the reference's
process-wide constants (ref: src/Config.{h,cpp}, src/SurfelMapping.cpp:254-365).

Reference constants reproduced here (src/Config.cpp:16-37):
  * surfel record = 3 x vec4 = 12 f32 (48 B)
  * near_clip = 1.0 m, far_clip = 30.0 m
  * surfel_fuse_distance_threshold_factor = 0.0
  * max_sqrt_vertices = 5000  (=> 25M surfel capacity)
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole camera model + image size.

    Mirrors the data loaded from the dataset's ``calibration.txt``
    (ref: gui/KittiReader.cpp:218-262).
    """

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.height, self.width)

    def scaled(self, factor: int) -> "CameraIntrinsics":
        """Intrinsics at ``factor``x resolution (ref: IndexMap FACTOR,
        src/IndexMap.cpp:21,160-166)."""
        if factor == 1:
            return self
        return CameraIntrinsics(
            fx=self.fx * factor,
            fy=self.fy * factor,
            cx=self.cx * factor,
            cy=self.cy * factor,
            width=self.width * factor,
            height=self.height * factor,
        )


@dataclasses.dataclass(frozen=True)
class PipelineParams:
    """All tunable constants of the fusion pipeline.

    Every value matches the reference's hardcoded call-site constants so the
    two engines are comparable surfel-for-surfel:

      * near/far clip:            src/Config.cpp:33-34
      * stereo_border:            src/SurfelMapping.cpp:261,308,358
      * filter_diff_thresh_*:     src/SurfelMapping.cpp:284,328
      * smooth sigma handling:    src/SurfelMapping.cpp:291-309 (note the
        reference passes the *intensity* sigma's 0.5/sigma^2 as the spatial
        weight "sigPix"; we reproduce that behaviour bit-for-bit)
      * move_thresh:              src/SurfelMapping.cpp:359
      * time_delta:               src/SurfelMapping.cpp:197
      * conf_new:                 src/Shaders/data.vert:104
      * merge gates:              src/Shaders/data.vert:151,158,177
      * fuse_thresh_factor:       src/Config.cpp:35 (0.0 during build),
                                  0.1 during cleanPoints (src/SurfelMapping.cpp:516)
      * conflict conf decrement:  src/Shaders/conflict.vert:72
      * semantic class ids:       src/Shaders/depth_filter.frag:24-26,
                                  depth_movings.frag:45-47 (cityscapes trainIds)
    """

    near_clip: float = 1.0
    far_clip: float = 30.0
    filter_cap_depth: float = 100.0
    stereo_border: float = 80.0
    filter_diff_thresh_1: float = 0.15
    filter_diff_thresh_2: float = 0.1
    filter_support_min: int = 7
    smooth_radius: int = 6
    smooth_sigma_pixel: float = 4.5
    smooth_sigma_intensity: float = 30.0
    move_thresh: float = 0.5
    time_delta: int = 200
    conf_new: float = 0.9
    merge_normal_angle: float = 0.5
    merge_radius_factor: float = 1.5
    fuse_thresh_factor: float = 0.0
    clean_fuse_thresh_factor: float = 0.1
    conflict_conf_decrement: float = 1.0
    index_factor: int = 1
    sparse_stride: int = 2  # 1/2 checkerboard sparsity (data.vert:88)

    # cityscapes trainId semantic classes
    sky_class: int = 10
    person_class: int = 11
    rider_class: int = 12
    movable_class_lo: int = 13  # car
    movable_class_hi: int = 18  # bicycle

    @property
    def smooth_sig_pix(self) -> float:
        # Reproduce the reference's (buggy but behavioural) choice of passing
        # 0.5 / sigma_intensity^2 as the spatial falloff coefficient
        # (src/SurfelMapping.cpp:291-309).
        return 0.5 / (self.smooth_sigma_intensity * self.smooth_sigma_intensity)


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Surfel map storage configuration.

    ``capacity`` is the slot count of the device-resident surfel buffer.
    The reference fixes this at 5000^2 = 25M slots (src/Config.cpp:37,
    src/GlobalModel.cpp:5-8); the host grows it in power-of-two-ish buckets
    so per-frame cost tracks the live map size rather than the worst case.
    """

    capacity: int = 1 << 20
    growth_factor: float = 2.0
    watermark: float = 0.85  # grow when count exceeds watermark * capacity

    # Active-block residency (ops/active.py): the map is partitioned into
    # fixed blocks; per-frame indexed work touches only blocks intersecting
    # the view frustum.  ``active_blocks`` bounds the gathered working set
    # (grown by the host when the frustum needs more); block granularity
    # works because surfels append in scan order (spatial locality).
    block_size: int = 2048
    active_blocks: int = 256
    active_watermark: float = 0.75  # grow active_blocks past this occupancy
    # Pin the budget at ``active_blocks`` (no auto grow/shrink tuning; the
    # correctness-critical overflow repair still grows it).
    freeze_active_budget: bool = False
    # Deferred removal: conflict tombstones (conf <= 0) are reclaimed by a
    # compaction only when they exceed this fraction of capacity (and at
    # checkpoint/clean boundaries).
    compact_dead_frac: float = 0.25

    def rounded_capacity(self, cap: int) -> int:
        """Round a slot count up to a whole number of blocks."""
        b = self.block_size
        return max(b, ((cap + b - 1) // b) * b)


DEFAULT_PARAMS = PipelineParams()

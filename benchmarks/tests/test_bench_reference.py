"""The plain references against hand cases and, at tiny sizes on the CPU,
against the port's own plain versions that they were frozen from."""

from __future__ import annotations

import numpy as np
import torch

from benchmarks.reference.mapping import preprocess as ref_pre
from benchmarks.reference.mapping import step, surfels, zbuf
from benchmarks.reference.mapping.config import CameraIntrinsics, PipelineParams
from benchmarks.reference.mapping.index_map import INT32_MAX


def test_the_z_buffer_by_hand():
    key = torch.tensor([5, 3, 3, 7, 1], dtype=torch.int32)
    pix = torch.tensor([0, 0, 0, 2, 9], dtype=torch.int32)  # 9: outside, discarded
    k, i = zbuf.zbuffer_argmin(key, pix, 3)
    assert k.tolist() == [3, INT32_MAX, 7] and i.tolist() == [1, INT32_MAX, 3]
    k, i = zbuf.zbuffer_argmin(key, pix, 3, torch.tensor(1, dtype=torch.int32))
    assert k.tolist() == [5, INT32_MAX, INT32_MAX] and i.tolist() == [0, INT32_MAX, INT32_MAX]


def test_the_stacked_smooth_equals_the_ports_one_tap_at_a_time():
    from surfelmapping_tpu_torch.config import PipelineParams as PortParams
    from surfelmapping_tpu_torch.io.synthetic import stencil_frame, tiny_cam
    from surfelmapping_tpu_torch.ops.preprocess import stencil_chain_plain

    cam = tiny_cam(120, 40)
    depth, sem = stencil_frame(40, 120, np.random.default_rng(1))
    d, s = torch.from_numpy(depth), torch.from_numpy(sem)
    ref_cam = CameraIntrinsics(**{k: getattr(cam, k) for k in ("fx", "fy", "cx", "cy",
                                                               "width", "height")})
    want = stencil_chain_plain(d, s, cam, PortParams())
    got = ref_pre.stencil_chain_plain(d, s, ref_cam, PipelineParams())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_live_records_compare_by_content_not_by_slot():
    a = surfels.empty_map(8, "cpu")
    a.px[:4] = torch.tensor([1.0, 2.0, 3.0, 4.0])
    a.conf[:4] = torch.tensor([1.0, -1.0, 1.0, 1.0])  # slot 1 a tombstone
    a.count = torch.tensor(4, dtype=torch.int32)
    b = surfels.empty_map(16, "cpu")                  # compacted, grown
    b.px[:3] = torch.tensor([1.0, 3.0, 4.0])
    b.conf[:3] = 1.0
    b.count = torch.tensor(3, dtype=torch.int32)
    assert step.record_mismatch(a, b) == 0
    b.px[2] = torch.nextafter(torch.tensor(4.0), torch.tensor(5.0))
    assert step.record_mismatch(a, b) == 1
    b.count = torch.tensor(2, dtype=torch.int32)
    assert step.record_mismatch(a, b) == 1


def test_the_reference_render_equals_the_ports_culled_render():
    """The reference renders the whole map with no cull; the port culls to
    the in-view blocks first.  The images are the same."""
    from surfelmapping_tpu_torch.config import CameraIntrinsics as PortCam
    from surfelmapping_tpu_torch.ops.splat import render_view
    from surfelmapping_tpu_torch.surfels import SurfelMap as PortMap
    from surfelmapping_tpu_torch.views import render_u8

    from benchmarks.reference.mapping.splat import render_u8 as ref_render

    g = torch.Generator().manual_seed(3)
    n, cap = 3000, 4096
    m = surfels.empty_map(cap, "cpu")
    m.px[:n] = torch.rand(n, generator=g) * 8 - 4
    m.py[:n] = torch.rand(n, generator=g) * 3 - 1.5
    m.pz[:n] = torch.rand(n, generator=g) * 20 + 2
    m.nz[:n] = -1.0
    m.conf[:n] = 1.0
    m.radius[:n] = torch.rand(n, generator=g) * 0.1 + 0.02
    m.colorsem[:n] = torch.randint(0, 2**24, (n,), generator=g, dtype=torch.int32) | (3 << 24)
    m.count = torch.tensor(n, dtype=torch.int32)
    cam = dict(fx=100.0, fy=100.0, cx=80.0, cy=48.0, width=160, height=96)
    view = torch.eye(4)
    port = PortMap(**{k: getattr(m, k) for k in PortMap.__dataclass_fields__})
    want = render_u8(render_view(port, view, PortCam(**cam), footprint=5, device="cpu"))
    got = ref_render(m, view, CameraIntrinsics(**cam), footprint=5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((got[1] > 0).sum()) > 1000

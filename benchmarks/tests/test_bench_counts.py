"""The work the kernels are credited with, the readers over a traced
stretch's records, and the attribution of the device's idle gaps, against
hand counts."""

from __future__ import annotations

import pytest

from benchmarks import harness, roofline


def test_k1_bytes_by_hand():
    # 1000 valid candidates: 4 B key + 4 B pixel each; a 4 B count; 50 pixels of 8 B
    assert roofline.k1_bytes(1000, 50, True) == 8000 + 4 + 400
    assert roofline.k1_bytes(1000, 50, False) == 8400
    assert roofline.k1_seconds(1000, 50, False) == pytest.approx(8400 / 3.35e12)


def test_k2_operations_and_bytes_by_hand():
    # radius 1: 9 smooth taps x 3 + 2 support passes x 8 taps x 2 + 1 divide
    assert roofline.k2_ops_per_pixel(1) == 27 + 32 + 1
    assert roofline.k2_ops_per_pixel(6) == 540
    assert roofline.k2_bytes(10, 1) == 120 + 36
    # at the KITTI frame K2 is bound by its operations: 0.00366 ms
    assert roofline.k2_seconds(453_620, 6) == pytest.approx(540 * 453_620 / 67e12)


def records(**kw):
    rec = {"items": 4, "window_s": 0.1, "busy_s": 0.025, "device_events": 400,
           "kernel_s": {"scatter_min(int const*, int const*)": 2e-5, "fill_empty(long long*)": 2e-5,
                        "void stencil_kernel<6>(float const*)": 4e-5, "other": 1e-3},
           "k1_calls": [(1000, 1000, 50, False)] * 2, "k2_calls": [(453_620, 6)]}
    rec.update(kw)
    return rec


def test_the_readers_by_hand():
    r = records()
    assert harness.reader("fuse.launches_per_frame").read(r) == 100
    assert harness.reader("fuse.busy_ms_per_frame").read(r) == pytest.approx(6.25)
    assert harness.reader("fuse.idle_share").read(r) == pytest.approx(75.0)
    k1 = harness.reader("k1_roofline.fuse").read(r)
    assert k1 == pytest.approx(100 * 2 * 8400 / 3.35e12 / 4e-5)
    k2 = harness.reader("k2_roofline.fuse").read(r)
    assert k2 == pytest.approx(100 * 540 * 453_620 / 67e12 / 4e-5)


def test_a_reader_with_nothing_to_read_reads_nothing():
    assert harness.reader("k1_roofline.render").read(records(k1_calls=[])) is None
    assert harness.reader("k2_roofline.fuse").read(records(kernel_s={"other": 1.0})) is None


def test_idle_time_goes_to_the_innermost_host_range_open_meanwhile():
    busy = [(0.0, 10.0), (20.0, 30.0), (45.0, 50.0)]
    spans = [(0.0, 60.0, "frame"), (12.0, 25.0, "associate"), (31.0, 40.0, "sync"),
             (62.0, 64.0, "late")]
    idle = harness.idle_by_range(busy, spans, 0.0, 70.0)
    # gaps 10-20, 30-45, 50-70: frame 10-12, 30-31, 40-45, 50-60; host 60-62, 64-70
    assert idle == {"frame": 18.0, "associate": 8.0, "sync": 9.0, "host": 8.0, "late": 2.0}


def test_kernel_names_are_shortened():
    assert harness.short_name("void stencil_kernel<6>(float const*, int const*)") == \
        "stencil_kernel<6>"
    assert harness.short_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"

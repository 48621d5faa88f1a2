"""The association stage's dispatch on the CPU: ``associate_active`` runs
the plain version for CPU tensors and never reaches the CUDA kernel, and
the kernel's wrapper refuses CPU tensors before it builds or launches
anything.  The kernel itself is held to the plain version on the card
(tests/test_torch_gpu.py, ``-k associate``)."""

import pytest

from surfelmapping_tpu_torch.ops import active
from surfelmapping_tpu_torch.ops import associate_merge as am
from surfelmapping_tpu_torch.tools.assoc_cases import CASES, association_case, differing_columns
from surfelmapping_tpu_torch.utils import tracing


@pytest.mark.parametrize("case", [c for c in CASES if c != "kitti"])
def test_associate_active_on_the_cpu_runs_the_plain_version(case, monkeypatch):
    args = association_case(case, "cpu")

    def kernel(*_):
        raise AssertionError("the CUDA kernel's wrapper was called for CPU tensors")

    monkeypatch.setattr(active, "associate_merge", kernel)
    before = am.KERNEL.launches
    tracing.enable()
    try:
        got = active.associate_active(*args)
        counted = [r for r in tracing.records() if r.name == "fuse.associate_kernel"]
    finally:
        tracing.enable(False)
    assert am.KERNEL.launches == before and counted == []
    want = active.associate_active_plain(*args)
    assert differing_columns(got, want) == {}
    marks = want.mark
    assert (marks >= 0).any() or case == "random"
    assert (marks == -1).any() and (marks == -10).any()


def test_associate_cases_cover_the_gates():
    """The surface case's pixels merge, stay new and are invalid; its index
    reaches tombstones, padding slots and empty windows."""
    args = association_case("surface", "cpu")
    rgb, index, table = args[1], args[3], args[4]
    want = active.associate_active_plain(*args)
    assert (want.mark >= 0).sum() > 0.5 * want.mark.numel()
    hit = index[index >= 0]
    assert (index == -1).any()
    assert (table.conf[hit] <= 0).any() and (~table.slot_valid[hit]).any()
    assert rgb.min() < 0 and rgb.max() > 1


def test_associate_kernel_wrapper_refuses_cpu_tensors():
    args = association_case("surface", "cpu")
    before = am.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        am.associate_merge(*args, fuse_thresh=args[-1].fuse_thresh_factor)
    assert am.KERNEL.launches == before

"""Port parity, the index map's scatter-argmin z-buffer: the port's wrapper
(its plain version on the CPU) against the JAX package's
``zbuffer_argmin_auto`` XLA path, on the four cases of
tests/test_pallas_zbuf.py: key min, min-id tie-break, invalid candidates and
empty pixels, a valid-prefix bound that is not a chunk multiple, and sizes
that are not a chunk multiple.  All exact.  Then the probe kernels P1
(``pallas_zbuf``) and P2 (``outres``), see below.  (The kernels against
their plain versions on the card: tests/test_torch_gpu.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from surfelmapping_tpu.ops.pallas_zbuf import zbuffer_argmin as jax_zbuffer_argmin
from surfelmapping_tpu.ops.pallas_zbuf import zbuffer_argmin_auto
from surfelmapping_tpu_torch.ops import zbuf, zbuf_outres
from surfelmapping_tpu_torch.ops.index_map import INT32_MAX
from tools.probe_pallas_zbuf import make_kernel, xla_zbuf
from tools.probe_zbuf_variants import make_outres_kernel


def _case(name):
    """(zkey, fpix, P, n_valid) of each case of tests/test_pallas_zbuf.py."""
    if name == "random":
        rng = np.random.default_rng(0)
        P, A = 5000, 4096
        zkey = rng.integers(0, 1 << 20, A).astype(np.int32)
        fpix = rng.integers(0, P, A).astype(np.int32)
        inval = rng.uniform(size=A) < 0.3
        zkey[inval] = INT32_MAX
        fpix[inval] = P
        return zkey, fpix, P, A
    if name == "tie_break":
        P, A = 200, 4096
        zkey = np.full(A, INT32_MAX, np.int32)
        fpix = np.zeros(A, np.int32)
        for cid in (3, 4, 5):
            zkey[cid] = 77
            fpix[cid] = 13
        zkey[9] = 12
        fpix[9] = 99
        return zkey, fpix, P, A
    if name == "n_valid_prefix":
        rng = np.random.default_rng(2)
        P, A, nv = 2000, 8192, 3000
        zkey = np.full(A, INT32_MAX, np.int32)
        fpix = np.full(A, P, np.int32)
        zkey[:nv] = rng.integers(0, 1 << 20, nv)
        fpix[:nv] = rng.integers(0, P, nv)
        return zkey, fpix, P, nv
    assert name == "non_chunk_multiple"
    rng = np.random.default_rng(1)
    P, A = 300, 1000
    return (rng.integers(0, 1 << 20, A).astype(np.int32),
            rng.integers(0, P, A).astype(np.int32), P, A)


CASES = ["random", "tie_break", "n_valid_prefix", "non_chunk_multiple"]


@pytest.mark.parametrize("name", CASES)
def test_zbuffer_matches_jax(name):
    zkey, fpix, P, nv = _case(name)
    A = zkey.shape[0]
    zr, ir = zbuffer_argmin_auto(jnp.asarray(zkey), jnp.asarray(fpix), P,
                                 n_valid=jnp.int32(nv))
    slot_valid = torch.arange(A) < nv
    zb, ib = zbuf.zbuffer_argmin(torch.from_numpy(zkey), torch.from_numpy(fpix), P, slot_valid)
    np.testing.assert_array_equal(zb.numpy(), np.asarray(zr))
    np.testing.assert_array_equal(ib.numpy(), np.asarray(ir))
    if name == "tie_break":
        assert (int(zb[13]), int(ib[13])) == (77, 3)
        assert (int(zb[99]), int(ib[99])) == (12, 9)
        empties = np.ones(P, bool)
        empties[[13, 99]] = False
        assert (zb.numpy()[empties] == INT32_MAX).all()
        assert (ib.numpy()[empties] == INT32_MAX).all()


@pytest.mark.parametrize("name", CASES)
def test_zbuffer_n_valid_and_packed_words_match_the_jax_kernel(name):
    """The plain version with a 0-d ``n_valid`` tensor, and the packed
    (key << 32) | id words with their strided key and id views, against the
    TPU kernel in interpret mode with the same ``n_valid``."""
    zkey, fpix, P, nv = _case(name)
    zr, ir = jax_zbuffer_argmin(jnp.asarray(zkey), jnp.asarray(fpix), P, interpret=True,
                                n_valid=jnp.int32(nv))
    zr, ir = np.asarray(zr), np.asarray(ir)
    zk, fp = torch.from_numpy(zkey), torch.from_numpy(fpix)
    n_valid = torch.tensor(nv, dtype=torch.int32)
    zp, ip = zbuf.zbuffer_argmin_plain(zk, fp, P, n_valid)
    np.testing.assert_array_equal(zp.numpy(), zr)
    np.testing.assert_array_equal(ip.numpy(), ir)
    packed = zbuf.zbuffer_argmin_packed(zk, fp, P, n_valid)
    assert packed.dtype == torch.int64 and packed.shape == (P,)
    np.testing.assert_array_equal(packed.numpy(),
                                  (zr.astype(np.int64) << 32) | ir.astype(np.int64))
    zb, ib = zbuf.key_id_views(packed)
    assert zb.stride() == ib.stride() == (2,)
    assert ib.data_ptr() == packed.data_ptr() and zb.data_ptr() == packed.data_ptr() + 4
    np.testing.assert_array_equal(zb.numpy(), zr)
    np.testing.assert_array_equal(ib.numpy(), ir)
    for valid in (n_valid, torch.arange(zkey.shape[0]) < nv):  # both forms, same views
        zv, iv = zbuf.zbuffer_argmin(zk, fp, P, valid)
        assert torch.equal(zv, zb) and torch.equal(iv, ib)


def test_candidates_past_the_prefix_do_not_exist():
    """Slots outside slot_valid never write, whatever their keys."""
    zkey = np.array([5, 3, 1, 1], np.int32)
    fpix = np.array([0, 0, 0, 1], np.int32)
    zb, ib = zbuf.zbuffer_argmin(torch.from_numpy(zkey), torch.from_numpy(fpix), 2,
                                 torch.tensor([True, True, False, False]))
    assert zb.tolist() == [3, INT32_MAX] and ib.tolist() == [1, INT32_MAX]


def test_valid_prefix_contract_is_checked():
    zkey = torch.zeros(8, dtype=torch.int32)
    fpix = torch.zeros(8, dtype=torch.int32)
    holes = torch.tensor([True, True, False, True, False, False, False, False])
    with pytest.raises(ValueError, match="prefix"):
        zbuf.zbuffer_argmin(zkey, fpix, 4, holes)



# ---- P1 / P2: the TPU probes' z-buffer kernels ----------------------------
#
# The port's probe entry points (their plain version on the CPU) against the
# TPU kernels of tools/probe_pallas_zbuf.py and tools/probe_zbuf_variants.py
# run in interpret mode, as tools/probe_pallas_zbuf.py:137-155 does, and
# against the probe's XLA reference ``xla_zbuf``.  All exact.


def _tpu_pallas_zbuf(zkey, fpix, P_pad):
    rows = P_pad // 128
    return pl.pallas_call(
        make_kernel(zkey.shape[0], P_pad),
        out_shape=(jax.ShapeDtypeStruct((rows, 128), jnp.int32),) * 2,
        interpret=True,
    )(jnp.asarray(zkey), jnp.asarray(fpix))


def _tpu_outres(zkey, fpix, num_pix, chunk):
    rows = -(-(num_pix + 1) // 128)
    zb, ib = pl.pallas_call(
        make_outres_kernel(zkey.shape[0], rows, chunk),
        out_shape=(jax.ShapeDtypeStruct((rows, 128), jnp.int32),) * 2,
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 2,
        out_specs=(pl.BlockSpec(memory_space=pltpu.VMEM),) * 2,
        scratch_shapes=[pltpu.SMEM((chunk,), jnp.int32), pltpu.SMEM((chunk,), jnp.int32),
                        pltpu.SemaphoreType.DMA((2,))],
        interpret=True,
    )(jnp.asarray(zkey), jnp.asarray(fpix))
    return zb.reshape(-1)[:num_pix], ib.reshape(-1)[:num_pix]


def _probe_case(P, seed, special):
    """4096 candidates in random pixel order over [0, P); ``special`` adds
    negative keys (the kernels compare signed int32), INT32_MAX keys (never
    written), a planted min-id tie and empty pixels."""
    rng = np.random.default_rng(seed)
    A = 4096
    zkey = rng.integers(-(1 << 30) if special else 0, 1 << 30, A).astype(np.int32)
    fpix = rng.integers(0, P, A).astype(np.int32)
    if special:
        zkey[rng.uniform(size=A) < 0.2] = INT32_MAX
        fpix[fpix == 13] = 14
        fpix[[7, 8, 900]] = 13
        zkey[[7, 8, 900]] = -(1 << 30) - 5
    return zkey, fpix


@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("num_pix,chunk", [(5000, 1024), (5000, 2048), (453_620, 1024)])
def test_outres_matches_the_tpu_kernel(num_pix, chunk, special):
    zkey, fpix = _probe_case(num_pix + 1, 3, special)   # num_pix itself is the spare
    zr, ir = _tpu_outres(zkey, fpix, num_pix, chunk)
    zb, ib = zbuf_outres.outres(torch.from_numpy(zkey), torch.from_numpy(fpix), num_pix, chunk)
    np.testing.assert_array_equal(zb.numpy(), np.asarray(zr))
    np.testing.assert_array_equal(ib.numpy(), np.asarray(ir))
    if special:
        assert (int(zb[13]), int(ib[13])) == (-(1 << 30) - 5, 7)
        assert (ib.numpy() == INT32_MAX).sum() > 0
    else:  # the probe's XLA reference (its win test needs no INT32_MAX keys)
        ids = jnp.arange(zkey.shape[0], dtype=jnp.int32)
        zx, ix = xla_zbuf(jnp.asarray(zkey), jnp.asarray(fpix), ids, num_pix + 1)
        np.testing.assert_array_equal(zb.numpy(), np.asarray(zx)[:num_pix])
        np.testing.assert_array_equal(ib.numpy(), np.asarray(ix)[:num_pix])


@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("P_pad", [5120, 453_632])
def test_pallas_zbuf_matches_the_tpu_kernel(P_pad, special):
    zkey, fpix = _probe_case(P_pad, 4, special)
    zr, ir = _tpu_pallas_zbuf(zkey, fpix, P_pad)
    zb, ib = zbuf_outres.pallas_zbuf(torch.from_numpy(zkey), torch.from_numpy(fpix), P_pad)
    assert zb.shape == ib.shape == (P_pad // 128, 128)
    np.testing.assert_array_equal(zb.numpy(), np.asarray(zr))
    np.testing.assert_array_equal(ib.numpy(), np.asarray(ir))
    if not special:
        ids = jnp.arange(zkey.shape[0], dtype=jnp.int32)
        zx, ix = xla_zbuf(jnp.asarray(zkey), jnp.asarray(fpix), ids, P_pad)
        np.testing.assert_array_equal(zb.numpy().reshape(-1), np.asarray(zx))
        np.testing.assert_array_equal(ib.numpy().reshape(-1), np.asarray(ix))


@pytest.mark.parametrize("entry", ["outres", "pallas_zbuf"])
def test_probe_entry_points_refuse_what_the_tpu_kernel_would_not_compute(entry):
    """A ragged candidate count (the TPU kernel drops the tail past the last
    whole chunk) and a pixel outside the buffer (the TPU kernel writes out of
    bounds) raise."""
    def call(zkey, fpix):
        if entry == "outres":
            return zbuf_outres.outres(zkey, fpix, 1000, 1024)     # buffer 1024 pixels
        return zbuf_outres.pallas_zbuf(zkey, fpix, 1024)
    chunk = 1024 if entry == "outres" else 2048
    ok = torch.zeros(chunk, dtype=torch.int32)
    call(ok, ok)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        call(ok[:-1], ok[:-1])
    for bad in (-1, 1024):
        fpix = ok.clone()
        fpix[5] = bad
        with pytest.raises(ValueError, match="outside the buffer"):
            call(ok, fpix)


# ---- the binned kernel's plan ----------------------------------------------
#
# csrc/zbuffer_outres.cu runs only on the card; its sizes come from
# ``outres_plan``, and the wrapper allocates its scratch from the plan.

PLAN_CASES = {
    "P1": (1 << 20, 453_632),
    "P2": (1 << 20, zbuf_outres.outres_pixels(4 * 453_620)),
    "ragged_pixels": (4096, 5 * 1024 + 77),
    "a_zero": (0, 453_632),
    "a_one": (1, 453_632),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_outres_plan(case):
    """The tiles cover n_pix exactly (the last one ragged where T does not
    divide it); each block's shared memory fits the H100's 227 KB; the
    probes' shapes give at least one tile per SM (132); the scratch is what
    the plan says."""
    A, n_pix = PLAN_CASES[case]
    plan = zbuf_outres.outres_plan(A, n_pix)
    T = plan.tile
    assert (plan.tiles - 1) * T < n_pix <= plan.tiles * T
    assert (n_pix % T != 0) == (case == "ragged_pixels")
    assert zbuf_outres.TILE_LOG2_RANGE[0] <= plan.tile_log2 <= zbuf_outres.TILE_LOG2_RANGE[1]
    assert max(plan.bin_smem, plan.tile_smem) <= zbuf_outres.SMEM_PER_BLOCK
    span = zbuf_outres.SPAN
    assert (plan.bin_blocks - 1) * span < A <= plan.bin_blocks * span or A == 0 == plan.bin_blocks
    if case in ("P1", "P2"):
        assert plan.tiles >= 132
        assert plan.tile == (1024 if case == "P1" else 4096)   # ~2048 candidates per tile
    entries, starts = zbuf_outres.outres_scratch(plan, "cpu")
    assert entries.dtype == torch.int64 and entries.shape == (plan.entries,) == (A,)
    assert starts.dtype == torch.int32
    assert starts.shape == (plan.starts,) == ((plan.tiles + 1) * plan.bin_blocks,)


def test_outres_plan_limits():
    """A dense buffer's tile (1024 pixels at 2^30 candidates) is widened
    while the pixels need more than MAX_TILES tiles; sizes the kernel cannot
    take raise."""
    n_pix = zbuf_outres.MAX_TILES * 1024 + 1
    assert zbuf_outres.default_tile_log2(2**30, n_pix) == 10
    assert zbuf_outres.outres_plan(2**30, n_pix).tile_log2 == 11
    with pytest.raises(ValueError, match="tiles"):
        zbuf_outres.outres_plan(8, zbuf_outres.MAX_TILES * (1 << 14) + 1)
    with pytest.raises(ValueError, match="int32"):
        zbuf_outres.outres_plan(2**31, 4096)
    with pytest.raises(ValueError, match="int32"):
        zbuf_outres.outres_plan(8, 2**31)

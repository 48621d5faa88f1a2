"""Port parity, the index map's scatter-argmin z-buffer: the port's wrapper
(its plain version on the CPU) against the JAX package's
``zbuffer_argmin_auto`` XLA path, on the four cases of
tests/test_pallas_zbuf.py: key min, min-id tie-break, invalid candidates and
empty pixels, a valid-prefix bound that is not a chunk multiple, and sizes
that are not a chunk multiple.  All exact.  (The kernel against this plain
version on the card: tests/test_torch_gpu.py.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfelmapping_tpu.ops.pallas_zbuf import zbuffer_argmin_auto
from surfelmapping_tpu_torch.ops import zbuf
from surfelmapping_tpu_torch.ops.index_map import INT32_MAX


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


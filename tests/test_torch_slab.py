"""The slab-entry table (K7, ops/slab.py) on the CPU, where its wrapper runs
the plain version.

`slab_entry_rows` is held to the TPU kernels' `_slab_entry_rows`
(rayfinder_tpu/ops/pallas_walk.py), called as plain jnp, exactly: the +inf
pattern and the NaN comparisons of axis-parallel rays included. The
reductions (need, group minima, front-to-back selection) are held to numpy
over that table.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rayfinder_tpu.ops.pallas_walk import _slab_entry_rows
from rayfinder_tpu_torch.ops import slab
from rayfinder_tpu_torch.ops.slab import slab_entry, slab_entry_reduce, slab_entry_rows


def _inputs(m, n, seed, axis_parallel=False):
    """m boxes and n rays (origin, inv_dir, bound) as numpy f32. With
    axis_parallel, a third of the direction components are 0 (inv_dir
    +-inf) and some origins lie on box planes, so that 0 * inf gives NaN."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-4, 4, (m, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.0, 2.0, (m, 3)).astype(np.float32)
    hi[::7, 1] = lo[::7, 1]  # flat boxes, as floor and wall leaves are
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    if axis_parallel:
        d[rng.random((n, 3)) < 1 / 3] = 0.0
        d[np.all(d == 0, axis=1), 2] = 1.0
        o[::5, 0] = lo[rng.integers(0, m, o[::5].shape[0]), 0]
    with np.errstate(divide="ignore"):
        inv = (np.float32(1.0) / d).astype(np.float32)
    bound = rng.uniform(0.5, 12.0, n).astype(np.float32)
    bound[::3] = 1e4
    return lo, hi, o, inv, bound


def _jax_table(lo, hi, o, inv, bound):
    return np.asarray(_slab_entry_rows(
        jnp.asarray(lo.T), jnp.asarray(hi.T), *(jnp.asarray(o[:, k]) for k in range(3)),
        *(jnp.asarray(inv[:, k]) for k in range(3)), jnp.asarray(bound)))


@pytest.mark.parametrize("axis_parallel", [False, True])
def test_slab_entry_rows_equals_jax_exactly(axis_parallel):
    lo, hi, o, inv, bound = _inputs(300, 200, seed=1, axis_parallel=axis_parallel)
    with np.errstate(invalid="ignore"):
        got = slab_entry_rows(*(torch.from_numpy(a) for a in (lo, hi, o, inv, bound))).numpy()
    want = _jax_table(lo, hi, o, inv, bound)
    assert got.shape == want.shape == (300, 200)
    assert np.isinf(want).any() and np.isfinite(want).any()
    np.testing.assert_array_equal(got, want)


def test_slab_entry_broadcasts_per_ray():
    lo, hi, o, inv, bound = (torch.from_numpy(a) for a in _inputs(64, 64, seed=2))
    table = slab_entry_rows(lo, hi, o, inv, bound)
    diagonal = slab_entry(lo, hi, o, inv, bound)
    assert torch.equal(diagonal, table.diagonal())


def _numpy_reduce(table, weight, bound, group):
    m, n = table.shape
    need = ((table < bound[None]) * weight[:, None].astype(np.int64)).sum(0)
    pad = -m % group
    padded = np.concatenate([table, np.full((pad, n), np.inf, np.float32)])
    gmin = padded.reshape(-1, group, n).min(1)
    masked = np.where(gmin < bound[None], gmin, np.inf)
    first = np.where(np.isfinite(masked.min(0)), masked.argmin(0), -1)
    return need, gmin, first


@pytest.mark.parametrize("group,chunk", [(128, 1 << 24), (5, 1 << 24), (7, 4096)])
@pytest.mark.parametrize("axis_parallel", [False, True])
def test_reductions_equal_numpy(monkeypatch, group, chunk, axis_parallel):
    """need, group minima and first group, over ragged groups and (with a
    small chunk) over many chunks of the plain version."""
    monkeypatch.setattr(slab, "_CHUNK_ENTRIES", chunk)
    lo, hi, o, inv, bound = _inputs(333, 150, seed=3, axis_parallel=axis_parallel)
    weight = np.random.default_rng(4).integers(1, 3, 333).astype(np.int32)
    table = _jax_table(lo, hi, o, inv, bound)
    want = _numpy_reduce(table, weight, bound, group)
    before = slab_entry_reduce.launches
    with np.errstate(invalid="ignore"):
        need, gmin, first = slab_entry_reduce(
            *(torch.from_numpy(a) for a in (lo, hi, weight, o, inv, bound)), group, True)
    assert slab_entry_reduce.launches == before
    assert need.dtype == first.dtype == torch.int32
    assert gmin.shape == (-(-333 // group), 150)
    np.testing.assert_array_equal(need.numpy(), want[0])
    np.testing.assert_array_equal(gmin.numpy(), want[1])
    np.testing.assert_array_equal(first.numpy(), want[2])
    assert (first.numpy() >= 0).any() and (first.numpy() == -1).any()
    without = slab_entry_reduce(*(torch.from_numpy(a) for a in (lo, hi, weight, o, inv, bound)),
                                group)
    assert without[1] is None
    assert torch.equal(without[0], need) and torch.equal(without[2], first)


@pytest.mark.parametrize("axis_parallel", [False, True])
def test_reductions_with_groups_straddling_the_kernel_chunks(axis_parallel):
    """The CUDA kernel stages boxes in chunks of 256 and closes a group
    wherever it ends: a group size (100) that neither divides 256 nor is
    divided by it, over a box count (777) that is a multiple of neither, and
    a ray count (130) that leaves the kernel's ray tile ragged. Here the
    plain version is held to numpy on that case; the card test holds the
    kernel to the plain version."""
    m, n, group = 777, 130, 100
    lo, hi, o, inv, bound = _inputs(m, n, seed=6, axis_parallel=axis_parallel)
    weight = np.random.default_rng(7).integers(1, 3, m).astype(np.int32)
    want = _numpy_reduce(_jax_table(lo, hi, o, inv, bound), weight, bound, group)
    with np.errstate(invalid="ignore"):
        need, gmin, first = slab_entry_reduce(
            *(torch.from_numpy(a) for a in (lo, hi, weight, o, inv, bound)), group, True)
    assert gmin.shape == (8, n)
    np.testing.assert_array_equal(need.numpy(), want[0])
    np.testing.assert_array_equal(gmin.numpy(), want[1])
    np.testing.assert_array_equal(first.numpy(), want[2])
    assert len(np.unique(first.numpy())) > 3


def test_group_must_be_positive():
    lo, hi, o, inv, bound = (torch.from_numpy(a) for a in _inputs(4, 4, seed=5))
    with pytest.raises(ValueError, match="group"):
        slab_entry_reduce(lo, hi, torch.ones(4, dtype=torch.int32), o, inv, bound, 0)

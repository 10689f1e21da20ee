"""Slab-entry table and its reductions (K7): CUDA kernel and plain versions.

Counterpart of the TPU's dense slab-entry table (`_slab_entry_rows`,
rayfinder_tpu/ops/pallas_walk.py; probed by prof/probe_prebuilt.py) and of
`render/wavefront._slab_entry`, which gives the bench's per-ray "need".

`slab_entry_rows` is the plain table: entry[m, n] = max(tmin, 0) where ray
n's slab test against box m accepts (with tmin < bound[n]), +inf where it
fails, with the NaN comparisons of axis-parallel rays. The kernel
(csrc/slab_entry.cu) computes, without writing that table, per ray:

- need (N,) int32: the sum of weight[m] over boxes with entry < bound;
- group_min (ceil(M / G), N) f32, if asked for: the minimum entry of each
  group of G consecutive boxes (the TPU probe's per-super `agg`);
- first_group (N,) int32: the first group whose minimum is the smallest
  one below bound (the front-to-back selection), -1 if none.

`slab_entry_reduce_reference` computes the same from the table, chunked
over boxes so that it fits in memory. A wrapper given CPU tensors runs the
plain version; given CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["slab_entry", "slab_entry_rows", "slab_entry_reduce", "slab_entry_reduce_reference"]

# Table entries per chunk of the plain reductions.
_CHUNK_ENTRIES = 1 << 24
# Operations per ray-box pair, counted as ops/counted.py counts the walk's:
# the slab test (25), max(tmin, 0), the bound test and the group minimum.
PAIR_OPS = 28


def slab_entry(box_min, box_max, origin, inv_dir, bound):
    """Entry distance of each ray into its box, broadcast over the leading
    dimensions (box_min, box_max, origin, inv_dir (..., 3), bound (...)):
    +inf where the slab test fails."""
    neg = inv_dir < 0.0
    near = torch.where(neg, box_max, box_min)
    far = torch.where(neg, box_min, box_max)
    t0 = (near - origin) * inv_dir
    t1 = (far - origin) * inv_dir
    t0x, t0y, t0z = t0.unbind(-1)
    t1x, t1y, t1z = t1.unbind(-1)
    tmin_xy = torch.maximum(t0x, t0y)
    tmax_xy = torch.minimum(t1x, t1y)
    fail_xy = (t0x > t1y) | (t0y > t1x)
    fail_z = (tmin_xy > t1z) | (t0z > tmax_xy)
    tmin = torch.maximum(tmin_xy, t0z)
    tmax = torch.minimum(tmax_xy, t1z)
    hit = ~fail_xy & ~fail_z & (tmin < bound) & (tmax > 0.0)
    return torch.where(hit, torch.clamp(tmin, min=0.0), torch.inf)


def slab_entry_rows(box_min, box_max, origin, inv_dir, bound):
    """(M, N) f32 entry distances of N rays (origin, inv_dir (N, 3), bound
    (N,)) into M boxes (box_min, box_max (M, 3)); +inf where the slab test
    fails."""
    return slab_entry(box_min[:, None], box_max[:, None], origin[None], inv_dir[None],
                      bound[None])


def slab_entry_reduce_reference(box_min, box_max, weight, origin, inv_dir, bound, group,
                                with_group_min=False):
    """Plain version of `slab_entry_reduce`: the table in chunks of whole
    groups, reduced per ray."""
    m, n = box_min.shape[0], origin.shape[0]
    dev = origin.device
    need = torch.zeros(n, dtype=torch.int64, device=dev)
    best = torch.full((n,), torch.inf, dtype=torch.float32, device=dev)
    first = torch.full((n,), -1, dtype=torch.int64, device=dev)
    mins = []
    chunk = max(1, _CHUNK_ENTRIES // max(n, 1) // group) * group
    for base in range(0, m, chunk):
        stop = min(base + chunk, m)
        entry = slab_entry_rows(box_min[base:stop], box_max[base:stop], origin, inv_dir, bound)
        need += ((entry < bound[None]).to(torch.int64) * weight[base:stop, None]).sum(0)
        pad = -(stop - base) % group
        if pad:
            entry = torch.cat([entry, entry.new_full((pad, n), torch.inf)])
        gmin = entry.reshape(-1, group, n).amin(1)
        if with_group_min:
            mins.append(gmin)
        masked = torch.where(gmin < bound[None], gmin, torch.inf)
        key, arg = masked.min(0)
        better = key < best
        best = torch.where(better, key, best)
        first = torch.where(better, arg + base // group, first)
    group_min = torch.cat(mins) if with_group_min else None
    return need.to(torch.int32), group_min, first.to(torch.int32)


def slab_entry_reduce(box_min, box_max, weight, origin, inv_dir, bound, group: int,
                      with_group_min: bool = False):
    """Per-ray reductions of the slab-entry table of M boxes (box_min,
    box_max (M, 3) f32, weight (M,) int32) and N rays (origin, inv_dir
    (N, 3) f32, bound (N,) f32), in groups of `group` boxes.

    Returns (need (N,) int32, group_min (ceil(M / group), N) f32 or None,
    first_group (N,) int32)."""
    if group < 1:
        raise ValueError(f"group must be positive, got {group}")
    if origin.device.type == "cpu":
        return slab_entry_reduce_reference(box_min, box_max, weight, origin, inv_dir, bound,
                                           group, with_group_min)
    dev = origin.device
    m, n = box_min.shape[0], origin.shape[0]
    for t, name, dtype, shape in (
        (box_min, "box_min", torch.float32, (m, 3)), (box_max, "box_max", torch.float32, (m, 3)),
        (weight, "weight", torch.int32, (m,)), (origin, "origin", torch.float32, (n, 3)),
        (inv_dir, "inv_dir", torch.float32, (n, 3)), (bound, "bound", torch.float32, (n,)),
    ):
        _build.check(t, name, dtype, shape, dev)
    need = torch.empty(n, dtype=torch.int32, device=dev)
    first = torch.empty(n, dtype=torch.int32, device=dev)
    group_min = (torch.empty(-(-m // group), n, dtype=torch.float32, device=dev)
                 if with_group_min else None)
    if n:
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.rf_slab_entry_reduce(
                box_min.data_ptr(), box_max.data_ptr(), weight.data_ptr(), m, group,
                origin.data_ptr(), inv_dir.data_ptr(), bound.data_ptr(), n, need.data_ptr(),
                group_min.data_ptr() if with_group_min else None, first.data_ptr(),
                _build.stream_of(dev),
            )
        _build.raise_on_error(err, "rf_slab_entry_reduce")
        slab_entry_reduce.launches += 1
    return need, group_min, first


# Kernel launch count (a run resets and reads it to show which kernels it
# went through).
slab_entry_reduce.launches = 0

"""Wavefront traversal: chunked cluster cull -> near-first top-k -> cluster walk.

Counterpart of `rayfinder_tpu.render.wavefront`, an engine the JAX package
runs in XLA (no Pallas kernel), so here it is torch code on whatever device
the scene is on. Its results are exact: the same accepted triangle set as the
per-ray stack walk (render/traverse.py), with the nearest hit chosen over
whole cluster blocks.

1. **Cull** (per ray chunk): every ray is slab-tested against every cluster
   box of the scene's cluster tables (render/scene.py) over a dense
   (chunk, C) grid.
2. **Order**: each ray's overlapped clusters are sorted by entry distance
   and the first `top_k` kept. A stable ascending sort of the score stands
   in for `jax.lax.top_k`, which puts tied scores in index order; in
   enclosed scenes many entries tie at 0 (the entry is max(tmin, 0)), and
   the visit order decides which triangle wins an equal-t hit and which
   clusters are kept at capacity.
3. **Walk**: a loop over the kept slots; in slot m every lane whose m-th
   entry is nearer than its best hit tests that cluster's whole (L, 3, 3)
   block with Moller-Trumbore, and the loop ends when no lane has such a
   slot left.

Capacity overflow is handled, not only reported: a ray overlapping more
than `top_k` cluster boxes is provably resolved only when its best hit is no
farther than the last kept entry (a dropped cluster enters later, and a hit
is never nearer than its cluster's entry). The other overflowed rays are
walked again at full cluster capacity in sub-batches of _ESC_CHUNK rays
(_escalate). Both queries return the number of such rays as an int32
tensor, as the JAX ones do.

    hit, t, tri, escalated = intersect_closest_wavefront(scene, o, d, t_max)
    occluded, escalated = intersect_any_wavefront(scene, o, d, t_max)
"""

from __future__ import annotations

import torch

from .intersect import _slab_terms, ray_triangle
from .scene import DeviceScene

RAY_CHUNK = 65536  # rays traversed per chunk (bounds the cull's temporaries)
MAX_CLUSTERS_PER_RAY = 32  # top-k capacity per ray
_MAX_CULL_ENTRIES = 32 * 1024 * 1024  # cap on the (chunk, C) cull grid
_ESC_CHUNK = 1024  # unresolved-overflow rays re-walked per escalation step


def _ray_chunk(num_clusters: int, num_rays: int | None = None) -> int:
    """Shrink the ray chunk for large scenes so the dense (chunk, C) cull
    grid stays at most _MAX_CULL_ENTRIES entries; never pad a small batch
    past the next power of two above its size."""
    chunk = RAY_CHUNK
    while chunk > 1024 and chunk * num_clusters > _MAX_CULL_ENTRIES:
        chunk //= 2
    if num_rays is not None:
        while chunk > 1024 and chunk // 2 >= num_rays:
            chunk //= 2
    return chunk


def _slab_entry(origin, inv_dir, dir_neg, aabb_min, aabb_max, t_max):
    """Slab test returning (hit, t_entry): the accept set of
    intersect.ray_aabb, and t_entry = max(tmin, 0)."""
    tmin, tmax, fail_xy, fail_z = _slab_terms(origin, inv_dir, dir_neg, aabb_min, aabb_max)
    hit = ~fail_xy & ~fail_z & (tmin < t_max) & (tmax > 0.0)
    return hit, torch.clamp(tmin, min=0.0)


def _order_clusters(scene: DeviceScene, origin, direction, t_max, top_k: int):
    """Cull + near-first ordering for one ray chunk.

    Returns (entry, cids, overflow): entry (K, top_k) ascending cluster entry
    distances (inf past the last overlapped cluster), cids (K, top_k) int64
    cluster ids, overflow (K,) bool capacity-exceeded flags. Ties keep the
    cluster order (a stable sort; + 0.0 makes -0.0 entries +0.0, so a radix
    sort on the card sees them tie too)."""
    inv_dir = 1.0 / direction
    dir_neg = inv_dir < 0.0
    hit, t_entry = _slab_entry(
        origin[:, None, :], inv_dir[:, None, :], dir_neg[:, None, :],
        scene.cluster_min[None, :, :], scene.cluster_max[None, :, :], t_max[:, None],
    )
    score = torch.where(hit, t_entry, torch.inf) + 0.0
    entry, cids = torch.sort(score, dim=1, stable=True)
    overflow = hit.sum(dim=-1) > top_k
    return entry[:, :top_k], cids[:, :top_k], overflow


def _blocks(scene: DeviceScene, cid):
    """(A,) cluster ids -> the (A, L, 3) vertex planes v0, v1, v2 of their
    triangle blocks."""
    blocks = scene.cluster_tris[cid]
    return blocks[:, :, 0], blocks[:, :, 1], blocks[:, :, 2]


def _walk_closest(scene: DeviceScene, origin, direction, t_max, entry, cids):
    """Near-first cluster walk with per-lane distance pruning. A slot is
    tested only on the lanes whose entry there is nearer than their best
    hit (the others' results are the JAX walk's masked-out ones)."""
    leaf = scene.cluster_tris.shape[1]
    best_t = t_max.clone()
    best_tri = torch.full_like(t_max, -1, dtype=torch.int32)
    for m in range(entry.shape[1]):
        act = torch.nonzero(entry[:, m] < best_t)[:, 0]
        if act.numel() == 0:
            break
        cid = cids[act, m]
        bound = best_t[act]
        hit, t, _, _ = ray_triangle(origin[act, None, :], direction[act, None, :],
                                    *_blocks(scene, cid), bound[:, None])
        t_masked = torch.where(hit, t, torch.inf)
        slot = torch.argmin(t_masked, dim=-1)  # the first minimum, as jnp.argmin
        block_t = t_masked.gather(1, slot[:, None])[:, 0]
        tri = scene.cluster_tri_map[cid * leaf + slot]
        better = block_t < bound
        best_t[act] = torch.where(better, block_t, bound)
        best_tri[act] = torch.where(better, tri, best_tri[act])
    found = best_tri >= 0
    return found, torch.where(found, best_t, t_max), best_tri


def _walk_any(scene: DeviceScene, origin, direction, t_max, entry, cids):
    """Any-hit cluster walk; lanes stop at the first intersection."""
    occluded = torch.zeros_like(t_max, dtype=torch.bool)
    for m in range(entry.shape[1]):
        act = torch.nonzero(torch.isfinite(entry[:, m]) & ~occluded)[:, 0]
        if act.numel() == 0:
            break
        hit, _, _, _ = ray_triangle(origin[act, None, :], direction[act, None, :],
                                    *_blocks(scene, cids[act, m]), t_max[act, None])
        occluded[act] = hit.any(dim=-1)
    return occluded


def _escalate(scene: DeviceScene, origin, direction, t_max, unresolved, walk, results):
    """Walk the `unresolved` rays again at FULL cluster capacity (k = the
    cluster count: no overflow is possible), _ESC_CHUNK rays at a time, and
    write their exact results into `results` (a tuple of per-ray 1-D
    tensors, updated in place)."""
    num_clusters = scene.cluster_tris.shape[0]
    rays = torch.nonzero(unresolved)[:, 0]
    for first in range(0, rays.numel(), _ESC_CHUNK):
        idx = rays[first:first + _ESC_CHUNK]
        o, d, tm = origin[idx], direction[idx], t_max[idx]
        entry, cids, _ = _order_clusters(scene, o, d, tm, num_clusters)
        for r, n in zip(results, walk(o, d, tm, entry, cids)):
            r[idx] = n
    return results


def _pad_rays(origin, direction, t_max, chunk: int):
    """Pad the ray batch to a chunk multiple with rays that miss everything."""
    num_rays = origin.shape[0]
    pad = -num_rays % chunk
    if pad == 0:
        return origin, direction, t_max, num_rays
    origin = torch.cat([origin, origin.new_full((pad, 3), 1e30)])
    direction = torch.cat([direction, direction.new_tensor([[1.0, 0.0, 0.0]]).expand(pad, 3)])
    t_max = torch.cat([t_max, t_max.new_ones(pad)])
    return origin, direction, t_max, num_rays


def _chunked(scene: DeviceScene, origin, direction, t_max, top_k: int, chunk_fn):
    """Run chunk_fn(o, d, t_max, k) over the padded ray batch chunk by chunk;
    returns its outputs concatenated and k."""
    num_clusters = scene.cluster_tris.shape[0]
    k = min(top_k, num_clusters)
    chunk = _ray_chunk(num_clusters, origin.shape[0])
    origin, direction, t_max, _ = _pad_rays(origin, direction, t_max, chunk)
    parts = [chunk_fn(origin[s:s + chunk], direction[s:s + chunk], t_max[s:s + chunk], k)
             for s in range(0, origin.shape[0], chunk)]
    return (origin, direction, t_max), [torch.cat(col) for col in zip(*parts)], k


def _ray_batch(origin, direction, t_max):
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=origin.device)
    return origin, direction, t_max.expand(origin.shape[0]).contiguous()


def intersect_closest_wavefront(scene: DeviceScene, origin, direction, t_max, *,
                                top_k: int = MAX_CLUSTERS_PER_RAY):
    """Closest-hit query. Returns (hit, t, tri_idx, escalated_count): t is
    t_max and tri -1 on a miss; escalated_count (int32 tensor) is the number
    of overflowed rays that had to be walked again at full capacity. Exact
    for every ray."""
    num_rays = origin.shape[0]
    origin, direction, t_max = _ray_batch(origin, direction, t_max)

    def chunk(o, d, tm, k):
        entry, cids, overflow = _order_clusters(scene, o, d, tm, k)
        hit, t, tri = _walk_closest(scene, o, d, tm, entry, cids)
        # A dropped cluster's entry >= the last kept entry, and a triangle
        # hit is never nearer than its cluster's entry, so t <= last kept
        # entry proves no dropped cluster can beat it.
        proven = hit & (t <= entry[:, -1])
        return hit, t, tri, overflow & ~proven

    rays, (hit, t, tri, unresolved), k = _chunked(scene, origin, direction, t_max, top_k, chunk)
    escalated = unresolved.sum(dtype=torch.int32)
    if k < scene.cluster_tris.shape[0]:  # a full-capacity walk drops nothing
        hit, t, tri = _escalate(scene, *rays, unresolved,
                                lambda o, d, tm, e, c: _walk_closest(scene, o, d, tm, e, c),
                                (hit, t, tri))
    return hit[:num_rays], t[:num_rays], tri[:num_rays], escalated


def intersect_any_wavefront(scene: DeviceScene, origin, direction, t_max, *,
                            top_k: int = MAX_CLUSTERS_PER_RAY):
    """Any-hit (shadow) query. Returns (occluded, escalated_count). Exact for
    every ray: an overflowed ray is done only when a kept cluster occluded
    it; the unoccluded ones are walked again at full capacity."""
    num_rays = origin.shape[0]
    origin, direction, t_max = _ray_batch(origin, direction, t_max)

    def chunk(o, d, tm, k):
        entry, cids, overflow = _order_clusters(scene, o, d, tm, k)
        occluded = _walk_any(scene, o, d, tm, entry, cids)
        return occluded, overflow & ~occluded

    rays, (occluded, unresolved), k = _chunked(scene, origin, direction, t_max, top_k, chunk)
    escalated = unresolved.sum(dtype=torch.int32)
    if k < scene.cluster_tris.shape[0]:
        (occluded,) = _escalate(scene, *rays, unresolved,
                                lambda o, d, tm, e, c: (_walk_any(scene, o, d, tm, e, c),),
                                (occluded,))
    return occluded[:num_rays], escalated

"""Near-first BVH stack walk over ray batches, in torch.

Counterpart of `rayfinder_tpu.render.traverse` (the JAX `reference` engine):
each ray walks the flattened BVH with a 32-deep stack (or, for a deeper
tree, the 64 of the scene's `walk_stack`, render/scene.py), near child first
(via `split_axis` and the direction's sign), leaf triangles in order -- the
reference's own traversal (src/common/ray_intersection.cpp:138-213,
reference_path_tracer.wgsl:370-429). The visit order, the `ray_aabb` bound
(the best t so far) and the stack's behaviour when full (a push at depth 32
is dropped, the pointer still moves) are those of the JAX loop, so `t`,
`tri` and `nodes_visited` agree with it exactly.

This is the specification of the traversal that the CUDA kernels run per
thread. Here all rays step in lockstep: one step is one node visit, and a
leaf's triangles are tested within the step that enters it; rays that
finish leave the batch. With `count`, it also counts each ray's leaves
entered and triangles tested, the counts the counted walk K6 returns.
Inside `with count_work() as work`, every walk counts, and `work` sums the
work of all of them: what a kernel's bound is computed from.

`intersect_packed` walks the same tree over the packed walk tables
(`bvh_nodes2`, `tri_pos4`) by the rule of the kernels' walk
(csrc/traverse2.cuh walk_packed): two children's slab tests per record, the
far child pushed with its entry distance, a popped entry taken iff that
distance is below the best t. It gives the same t, tri, occlusion and
counts as the walk above, and is the plain version of the ray queries K1
and K2; with `count` it counts as the kernels' counting level 2 does.
"""

from __future__ import annotations

import torch

from .intersect import ray_aabb, ray_aabb_entry, ray_triangle
from .scene import WALK_STACK, DeviceScene

# The stack's entries; a scene whose tree is deeper has its own (walk_stack).
STACK_DEPTH = WALK_STACK

_work = None


class count_work:
    """Context in which every plain walk also counts its work. The value is
    {"closest": [rays, nodes, leaves, tests], "any": [...]}, summed over the
    walks run inside the context."""

    def __enter__(self):
        global _work
        _work = {"closest": [0, 0, 0, 0], "any": [0, 0, 0, 0]}
        return _work

    def __exit__(self, *exc):
        global _work
        _work = None


def _traverse(scene: DeviceScene, origin, direction, t_max, any_hit: bool,
              count: bool = False):
    if _work is None or count:
        return _walk(scene, origin, direction, t_max, any_hit, count)
    hit, t, tri, counts = _walk(scene, origin, direction, t_max, any_hit, True)
    sums = _work["any" if any_hit else "closest"]
    sums[0] += counts.shape[0]
    for k, total in enumerate(counts.sum(0, dtype=torch.int64).tolist()):
        sums[k + 1] += total
    return hit, t, tri, counts[:, 0]


def _test_leaves(o, d, tris, v0, v1, v2, n_tri, bound, best, stop, any_hit: bool):
    """Test the triangles `tris` (L, S) of the leaves that rays o, d (L, 3)
    enter, in leaf order against the shrinking bound; slots k >= n_tri are
    padding. All slots are tested at once without the bound; `t < bound`,
    the test's one bound-dependent term, is then applied slot by slot.
    Returns the new (bound, best, stop) and each ray's triangles tested."""
    geo_hit, t, _, _ = ray_triangle(o[:, None], d[:, None], v0, v1, v2, float("inf"))
    tested = torch.zeros_like(n_tri)
    for k in range(tris.shape[1]):
        live = (k < n_tri) & ~stop
        tested += live.to(n_tri.dtype)
        hit = live & geo_hit[:, k] & (t[:, k] < bound)
        bound = torch.where(hit, t[:, k], bound)
        best = torch.where(hit, tris[:, k].to(torch.int32), best)
        if any_hit:
            stop = stop | hit
    return bound, best, stop, tested


def _walk(scene: DeviceScene, origin, direction, t_max, any_hit: bool, count: bool):
    """origin/direction: (B, 3) f32; t_max: float or (B,) f32.

    Returns (hit, t, tri_idx, nodes_visited), each (B,); for any_hit the
    walk stops at the first accepted intersection (shadow rays,
    wgsl:321-368). With count, nodes_visited is (B, 3) int32: nodes
    visited, leaves entered, triangles tested."""
    batch = origin.shape[0]
    dev = origin.device
    inv_dir = 1.0 / direction
    t_full = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(batch).clone()
    tri_full = torch.full((batch,), -1, dtype=torch.int32, device=dev)
    visits_full = torch.zeros((batch, 3) if count else (batch,), dtype=torch.int32, device=dev)
    if batch == 0:
        return tri_full >= 0, t_full, tri_full, visits_full

    max_leaf = int(scene.bvh_tri_count.max())
    pos = scene.tri_positions
    slot_k = torch.arange(max_leaf, device=dev)
    # Per-ray state of the rays still walking; `done` rays leave the batch
    # once a quarter of it has finished.
    lane = torch.arange(batch, device=dev)
    o, d, inv = origin, direction, inv_dir
    neg = inv < 0.0
    t_best, hit_tri = t_full.clone(), tri_full.clone()
    visits = visits_full.clone()
    node = torch.zeros(batch, dtype=torch.long, device=dev)
    sp = torch.zeros(batch, dtype=torch.long, device=dev)
    entries = scene.walk_stack
    stack = torch.zeros(batch, entries, dtype=torch.int32, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)

    while lane.numel():
        active = ~done
        if count:
            visits[:, 0] += active.to(torch.int32)
        else:
            visits = visits + active.to(torch.int32)
        aabb_hit = active & ray_aabb(
            o, inv, neg, scene.bvh_aabb_min[node], scene.bvh_aabb_max[node], t_best
        )
        tri_count = scene.bvh_tri_count[node]
        is_leaf = tri_count > 0

        # Leaf hit: test its triangles in order against the shrinking bound.
        leaf = torch.nonzero(aabb_hit & is_leaf)[:, 0]
        if leaf.numel():
            tris = (scene.bvh_tri_offset[node[leaf]].long()[:, None] + slot_k).clamp(
                max=scene.num_triangles - 1)
            v = pos[tris]  # (leaves, max_leaf, 3, 3)
            t_best[leaf], hit_tri[leaf], done[leaf], tested = _test_leaves(
                o[leaf], d[leaf], tris, v[:, :, 0], v[:, :, 1], v[:, :, 2], tri_count[leaf],
                t_best[leaf], hit_tri[leaf], done[leaf], any_hit)
            if count:
                visits[leaf, 1] += 1
                visits[leaf, 2] += tested

        # Interior hit: push the far child, descend into the near child
        # (near-first via dirNeg[splitAxis], wgsl:408-418).
        descend = aabb_hit & ~is_leaf
        axis = scene.bvh_split_axis[node].long()
        axis_neg = torch.gather(neg, 1, axis[:, None])[:, 0]
        second = scene.bvh_second_child[node].long()
        near = torch.where(axis_neg, second, node + 1)
        far = torch.where(axis_neg, node + 1, second)
        push = torch.nonzero(descend & (sp < entries))[:, 0]
        stack[push, sp[push]] = far[push].to(torch.int32)
        sp = torch.where(descend, sp + 1, sp)
        node = torch.where(descend, near, node)

        # Pop: rays that missed the box or finished a leaf.
        want_pop = active & ~descend & ~done
        done = done | (want_pop & (sp == 0))
        do_pop = want_pop & (sp > 0)
        sp = torch.where(do_pop, sp - 1, sp)
        popped = torch.gather(stack, 1, sp.clamp(max=entries - 1)[:, None])[:, 0]
        node = torch.where(do_pop, popped.long(), node)

        n_done = int(done.sum())
        if 4 * n_done >= lane.numel():
            fin = lane[done]
            t_full[fin] = t_best[done]
            tri_full[fin] = hit_tri[done]
            visits_full[fin] = visits[done]
            keep = ~done
            lane, o, d, inv, neg = lane[keep], o[keep], d[keep], inv[keep], neg[keep]
            t_best, hit_tri, visits = t_best[keep], hit_tri[keep], visits[keep]
            node, sp, stack = node[keep], sp[keep], stack[keep]
            done = done[keep]

    return tri_full >= 0, t_full, tri_full, visits_full


def intersect_closest(scene: DeviceScene, origin, direction, t_max):
    """Closest-hit walk (wgsl rayIntersectBvh semantics). Returns
    (hit, t, tri_idx, nodes_visited), each (B,); tri_idx is in leaf order,
    -1 on a miss, and t is t_max there."""
    return _traverse(scene, origin, direction, t_max, any_hit=False)


def intersect_closest_counted(scene: DeviceScene, origin, direction, t_max):
    """intersect_closest that also counts each ray's work. Returns (hit, t,
    tri_idx, counts): counts (B, 3) int32 = nodes visited, leaves entered,
    triangles tested; the first column is intersect_closest's
    nodes_visited."""
    return _traverse(scene, origin, direction, t_max, any_hit=False, count=True)


def intersect_any(scene: DeviceScene, origin, direction, t_max):
    """Any-hit walk for shadow rays (wgsl shadowRay semantics). Returns
    occluded: (B,) bool."""
    return _traverse(scene, origin, direction, t_max, any_hit=True)[0]


def intersect_packed(scene: DeviceScene, origin, direction, t_max, any_hit: bool = False,
                     count: bool = False):
    """The walk of csrc/traverse2.cuh over `scene.bvh_nodes2` and
    `scene.tri_pos4`, in lockstep: one step processes a record, tests a
    leaf or pops one stack entry. origin/direction (B, 3) f32; t_max float
    or (B,) f32.

    Returns (hit, t, tri, slab_tests), each (B,); for a closest-hit walk
    slab_tests equals `intersect_closest`'s nodes_visited. With count, the
    last is (B, 3) int32: slab tests, leaf entries taken and triangles
    tested (walk_packed's counting level 2; for a closest-hit walk
    `intersect_closest_counted`'s counts)."""
    batch = origin.shape[0]
    dev = origin.device
    inv_dir = 1.0 / direction
    t_full = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(batch).clone()
    tri_full = torch.full((batch,), -1, dtype=torch.int32, device=dev)
    tests_full = torch.ones(batch, dtype=torch.int32, device=dev)
    leaves_full = torch.zeros(batch, dtype=torch.int32, device=dev)
    tris_full = torch.zeros(batch, dtype=torch.int32, device=dev)

    def result():
        work = torch.stack([tests_full, leaves_full, tris_full], 1) if count else tests_full
        return tri_full >= 0, t_full, tri_full, work

    if batch == 0:
        return result()

    nodes = scene.bvh_nodes2
    lane = torch.arange(batch, device=dev)
    o, d, inv = origin, direction, inv_dir
    neg = inv < 0.0
    t_best, hit_tri, tests = t_full.clone(), tri_full.clone(), tests_full.clone()
    leaves, tris_tested = leaves_full.clone(), tris_full.clone()
    # The root: its box from the SoA planes, then record 0 or its leaf.
    take = ray_aabb_entry(o, inv, neg, scene.bvh_aabb_min[0], scene.bvh_aabb_max[0]) < t_best
    size = torch.where(take, scene.bvh_tri_count[0].long(), 0)
    ref = torch.where(size > 0, scene.bvh_tri_offset[0].long(), 0)
    sp = torch.zeros(batch, dtype=torch.long, device=dev)
    entries = scene.walk_stack
    stack_ref = torch.zeros(batch, entries, dtype=torch.long, device=dev)
    stack_count = torch.zeros(batch, entries, dtype=torch.long, device=dev)
    stack_key = torch.zeros(batch, entries, dtype=torch.float32, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)

    while lane.numel():
        leaf = torch.nonzero(~done & take & (size > 0))[:, 0]
        rec = torch.nonzero(~done & take & (size <= 0))[:, 0]
        pop = torch.nonzero(~done & ~take)[:, 0]

        if leaf.numel():
            n_tri = size[leaf]
            tris = (ref[leaf, None] + torch.arange(int(n_tri.max()), device=dev)).clamp(
                max=scene.num_triangles - 1)
            v = scene.tri_pos4[tris]  # (leaves, max_leaf, 12)
            t_best[leaf], hit_tri[leaf], done[leaf], tested = _test_leaves(
                o[leaf], d[leaf], tris, v[..., 0:3], v[..., 4:7], v[..., 8:11], n_tri,
                t_best[leaf], hit_tri[leaf], done[leaf], any_hit)
            leaves[leaf] += 1
            tris_tested[leaf] += tested.to(torch.int32)
            take[leaf] = False

        if rec.numel():
            row = nodes[ref[rec]]
            box = row[:, :12].view(torch.float32)
            args = (o[rec], inv[rec], neg[rec])
            key_l = ray_aabb_entry(*args, box[:, 0:3], box[:, 3:6])
            key_r = ray_aabb_entry(*args, box[:, 6:9], box[:, 9:12])
            tests[rec] += 2
            axis = ((row[:, 15] >> 30) & 3).long()
            axis_neg = torch.gather(neg[rec], 1, axis[:, None])[:, 0]
            left_ref, right_ref = row[:, 12].long(), row[:, 13].long()
            left_count, right_count = row[:, 14].long(), (row[:, 15] & 0x3FFFFFFF).long()
            far = (torch.where(axis_neg, left_ref, right_ref),
                   torch.where(axis_neg, left_count, right_count),
                   torch.where(axis_neg, key_l, key_r))
            push = torch.nonzero(sp[rec] < entries)[:, 0]
            slot = (rec[push], sp[rec[push]])
            stack_ref[slot], stack_count[slot], stack_key[slot] = (x[push] for x in far)
            sp[rec] += 1
            ref[rec] = torch.where(axis_neg, right_ref, left_ref)
            size[rec] = torch.where(axis_neg, right_count, left_count)
            take[rec] = torch.where(axis_neg, key_r, key_l) < t_best[rec]

        if pop.numel():
            empty = sp[pop] == 0
            done[pop[empty]] = True
            pop = pop[~empty]
            sp[pop] -= 1
            slot = (pop, sp[pop].clamp(max=entries - 1))
            ref[pop], size[pop] = stack_ref[slot], stack_count[slot]
            take[pop] = stack_key[slot] < t_best[pop]

        n_done = int(done.sum())
        if 4 * n_done >= lane.numel():
            fin = lane[done]
            t_full[fin], tri_full[fin], tests_full[fin] = t_best[done], hit_tri[done], tests[done]
            leaves_full[fin], tris_full[fin] = leaves[done], tris_tested[done]
            keep = ~done
            lane, o, d, inv, neg = lane[keep], o[keep], d[keep], inv[keep], neg[keep]
            t_best, hit_tri, tests = t_best[keep], hit_tri[keep], tests[keep]
            leaves, tris_tested = leaves[keep], tris_tested[keep]
            take, size, ref, sp = take[keep], size[keep], ref[keep], sp[keep]
            stack_ref, stack_count, stack_key = stack_ref[keep], stack_count[keep], stack_key[keep]
            done = done[keep]

    return result()

"""The reference's own BVH and its walks, in torch.

The tree is built from the triangles alone, on their device: top-down, level
by level, each node's triangles sorted by centroid along the longest axis of
their centroid bounds and split at the median, down to leaves of at most
LEAF triangles. It is not the program's tree (the program builds a SAH tree
on the host), so a ray finds the same closest hit in both except where two
triangles lie at the same distance.

The walks step every ray of a batch in lockstep, one node per step: at an
interior node both children's boxes are tested, the nearer taken and the
farther pushed with its entry distance; a popped entry is taken iff that
distance is below the best t so far. The arithmetic of the box and triangle
tests is the renderer's (slab test with the reference's asymmetric compares,
Moller-Trumbore with EPSILON 1e-5), written out in the same order. With
`counts`, a walk also returns the slab and triangle tests it made (the
few rays finished by testing every triangle, see TAIL_STEPS, count the
tests they had made until then).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

EPSILON = 1e-5
LEAF = 2
STACK = 64
# After TAIL_STEPS steps, once at most TAIL_RAYS rays still walk (grazing
# rays visit hundreds of nodes, one step each), they are finished by testing
# every triangle, BRUTE_PAIRS ray-triangle pairs at a time: the same closest
# hit, in far fewer steps.
TAIL_STEPS = 64
TAIL_RAYS = 2048
BRUTE_PAIRS = 1 << 24


class Bvh(NamedTuple):
    lo: torch.Tensor  # (N, 3) node boxes
    hi: torch.Tensor
    left: torch.Tensor  # (N,) int64 child ids, -1 at a leaf
    right: torch.Tensor
    first: torch.Tensor  # (N,) int64 leaf range into `tris`
    count: torch.Tensor  # (N,) int64, 0 at an interior node
    tris: torch.Tensor  # (T, 3, 3) triangles in leaf order
    tri_id: torch.Tensor  # (T,) int64 the original index of each


def build(positions: torch.Tensor) -> Bvh:
    """The median-split tree over (T, 3, 3) float32 triangles."""
    dev = positions.device
    t = positions.shape[0]
    cent = positions.mean(dim=1)
    order = torch.arange(t, device=dev)
    # Segments of the current level: node id, first, count.
    seg_node = torch.zeros(1, dtype=torch.long, device=dev)
    seg_first = torch.zeros(1, dtype=torch.long, device=dev)
    seg_count = torch.full((1,), t, dtype=torch.long, device=dev)
    left, first = [], []  # per level: (parents, left children, right), (leaves, first, count)
    n_nodes = 1
    while seg_node.numel():
        split = seg_count > LEAF
        # Leaves of this level.
        leaf_nodes = seg_node[~split]
        first.append((leaf_nodes, seg_first[~split], seg_count[~split]))
        if not bool(split.any()):
            break
        sn, sf, sc = seg_node[split], seg_first[split], seg_count[split]
        s = sn.numel()
        # The splitting segments' elements: their segment and position.
        idx = torch.repeat_interleave(torch.arange(s, device=dev), sc)
        pos = torch.repeat_interleave(sf, sc) + (
            torch.arange(idx.numel(), device=dev) - torch.repeat_interleave(
                torch.cumsum(sc, 0) - sc, sc))
        c = cent[order[pos]]
        lo = torch.full((s, 3), float("inf"), device=dev).scatter_reduce(
            0, idx[:, None].expand(-1, 3), c, "amin")
        hi = torch.full((s, 3), float("-inf"), device=dev).scatter_reduce(
            0, idx[:, None].expand(-1, 3), c, "amax")
        axis = torch.argmax(hi - lo, dim=1)
        key = c.gather(1, axis[idx][:, None])[:, 0]
        o1 = torch.argsort(key, stable=True)
        o2 = torch.argsort(idx[o1], stable=True)
        perm = o1[o2]
        order[pos] = order[pos[perm]]
        half = sc // 2
        lnode = n_nodes + 2 * torch.arange(s, device=dev)
        rnode = lnode + 1
        n_nodes += 2 * s
        left.append((sn, lnode, rnode))
        seg_node = torch.stack([lnode, rnode], 1).reshape(-1)
        seg_first = torch.stack([sf, sf + half], 1).reshape(-1)
        seg_count = torch.stack([half, sc - half], 1).reshape(-1)

    lft = torch.full((n_nodes,), -1, dtype=torch.long, device=dev)
    rgt = torch.full((n_nodes,), -1, dtype=torch.long, device=dev)
    for sn, ln, rn in left:
        lft[sn], rgt[sn] = ln, rn
    fst = torch.zeros(n_nodes, dtype=torch.long, device=dev)
    cnt = torch.zeros(n_nodes, dtype=torch.long, device=dev)
    for nodes, f, c in first:
        fst[nodes], cnt[nodes] = f, c
    tris = positions[order]
    # Leaf boxes from their triangles, then interior boxes level by level up.
    lo = torch.full((n_nodes, 3), float("inf"), device=dev)
    hi = torch.full((n_nodes, 3), float("-inf"), device=dev)
    leaf = torch.nonzero(cnt > 0)[:, 0]
    owner = torch.repeat_interleave(leaf, cnt[leaf])
    tmin = tris.amin(dim=1)
    tmax = tris.amax(dim=1)
    elem = torch.repeat_interleave(fst[leaf], cnt[leaf]) + (
        torch.arange(owner.numel(), device=dev)
        - torch.repeat_interleave(torch.cumsum(cnt[leaf], 0) - cnt[leaf], cnt[leaf]))
    lo.scatter_reduce_(0, owner[:, None].expand(-1, 3), tmin[elem], "amin")
    hi.scatter_reduce_(0, owner[:, None].expand(-1, 3), tmax[elem], "amax")
    for sn, ln, rn in reversed(left):
        lo[sn] = torch.minimum(lo[ln], lo[rn])
        hi[sn] = torch.maximum(hi[ln], hi[rn])
    return Bvh(lo, hi, lft, rgt, fst, cnt, tris, order)


def cast(bvh: Bvh, dtype) -> Bvh:
    """The tree with its boxes and triangles in `dtype`."""
    return bvh._replace(lo=bvh.lo.to(dtype), hi=bvh.hi.to(dtype), tris=bvh.tris.to(dtype))


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _dot(a, b):
    p0, p1, p2 = (a * b).unbind(-1)
    return p0 + p1 + p2


def ray_triangle(origin, direction, v0, v1, v2, t_max):
    """Moller-Trumbore (the renderer's order). Returns (hit, t, u, v)."""
    e1 = v1 - v0
    e2 = v2 - v0
    h = _cross(direction, e2)
    det = _dot(e1, h)
    inv_det = 1.0 / det
    s = origin - v0
    u = inv_det * _dot(s, h)
    q = _cross(s, e1)
    v = inv_det * _dot(direction, q)
    t = inv_det * _dot(e2, q)
    hit = ((torch.abs(det) >= EPSILON) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t > EPSILON) & (t < t_max))
    return hit, t, u, v


def _entry(origin, inv_dir, neg, lo, hi):
    """The slab test's entry distance, +inf where it fails (any leading
    shape, xyz last)."""
    near = torch.where(neg, hi, lo)
    far = torch.where(neg, lo, hi)
    t0 = (near - origin) * inv_dir
    t1 = (far - origin) * inv_dir
    tmin_xy = torch.maximum(t0[..., 0], t0[..., 1])
    tmax_xy = torch.minimum(t1[..., 0], t1[..., 1])
    fail = (t0[..., 0] > t1[..., 1]) | (t0[..., 1] > t1[..., 0])
    fail = fail | (tmin_xy > t1[..., 2]) | (t0[..., 2] > tmax_xy)
    tmin = torch.maximum(tmin_xy, t0[..., 2])
    tmax = torch.minimum(tmax_xy, t1[..., 2])
    return torch.where(~fail & (tmax > 0.0), tmin, torch.inf)


def _brute(bvh: Bvh, origin, direction, t_max, any_hit, act, best_t, best):
    """Finish rays `act` by testing every triangle (the lowest leaf-order
    index of equal nearest ones); best_t and best are updated in place."""
    tris = bvh.tris
    per = max(1, BRUTE_PAIRS // tris.shape[0])
    for a in range(0, act.numel(), per):
        rows = act[a:a + per]
        hit, t, _, _ = ray_triangle(origin[rows, None], direction[rows, None], tris[None, :, 0],
                                    tris[None, :, 1], tris[None, :, 2], t_max)
        t = torch.where(hit, t, torch.inf)
        k = torch.argmin(t, dim=1)
        t_k = t.gather(1, k[:, None])[:, 0]
        found = torch.isfinite(t_k)
        best_t[rows] = torch.where(found, t_k, best_t[rows])
        best[rows] = torch.where(found, bvh.tri_id[k], best[rows])


def walk(bvh: Bvh, origin, direction, t_max: float, any_hit: bool, counts: bool = False):
    """Closest hit (any_hit False) or occlusion (True) of (R, 3) rays below
    t_max. Returns (hit, t, tri) with tri the original triangle index (-1
    at a miss), and with `counts` also (slab tests, triangle tests) as
    Python ints."""
    dev = origin.device
    dt = bvh.tris.dtype
    origin = origin.to(dt)
    direction = direction.to(dt)
    r = origin.shape[0]
    inv = 1.0 / direction
    neg = inv < 0.0  # -0.0 is negative: its inverse is -inf
    best_t = torch.full((r,), t_max, dtype=dt, device=dev)
    best = torch.full((r,), -1, dtype=torch.long, device=dev)
    node = torch.zeros(r, dtype=torch.long, device=dev)
    stack = torch.zeros(r, STACK, dtype=torch.long, device=dev)
    stack_t = torch.zeros(r, STACK, dtype=dt, device=dev)
    sp = torch.zeros(r, dtype=torch.long, device=dev)
    # The root's own box.
    root = _entry(origin, inv, neg, bvh.lo[:1].expand(r, 3), bvh.hi[:1].expand(r, 3))
    act = torch.nonzero(root < best_t)[:, 0]
    # A leaf's triangles at once: as many slots as the largest leaf holds.
    slot = torch.arange(max(LEAF, int(bvh.count.max())), device=dev)
    slabs, tests = r, 0
    steps = 0
    while act.numel():
        steps += 1
        if steps > TAIL_STEPS and act.numel() <= TAIL_RAYS:
            _brute(bvh, origin, direction, t_max, any_hit, act, best_t, best)
            break
        n = node[act]
        o, d = origin[act], direction[act]
        cnt = bvh.count[n]
        is_leaf = cnt > 0
        bt = best_t[act]
        bi = best[act]
        # Leaves: their triangles at once; the nearest below the best t wins,
        # the first of equal ones (as testing them in order with a strict <).
        sel = is_leaf[:, None] & (slot[None, :] < cnt[:, None])
        j = torch.where(sel, bvh.first[n][:, None] + slot, 0)
        tri = bvh.tris[j]
        hit, t, _, _ = ray_triangle(o[:, None], d[:, None], tri[:, :, 0], tri[:, :, 1],
                                    tri[:, :, 2], bt[:, None])
        t = torch.where(sel & hit, t, torch.inf)
        k = torch.argmin(t, dim=1)
        t_k = t.gather(1, k[:, None])[:, 0]
        take = torch.isfinite(t_k)
        bt = torch.where(take, t_k, bt)
        bi = torch.where(take, bvh.tri_id[j.gather(1, k[:, None])[:, 0]], bi)
        if counts:
            tests = tests + sel.sum()
        best_t[act], best[act] = bt, bi
        # Interior: both children.
        lc = torch.where(is_leaf, 0, bvh.left[n])
        rc = torch.where(is_leaf, 0, bvh.right[n])
        kids = torch.stack([lc, rc], 1)
        e = _entry(o[:, None], inv[act][:, None], neg[act][:, None], bvh.lo[kids], bvh.hi[kids])
        el, er = e[:, 0], e[:, 1]
        if counts:
            slabs = slabs + 2 * (~is_leaf).sum()
        tl = ~is_leaf & (el < bt)
        tr = ~is_leaf & (er < bt)
        both = tl & tr
        r_first = er < el
        near = torch.where(both, torch.where(r_first, rc, lc), torch.where(tl, lc, rc))
        far = torch.where(r_first, lc, rc)
        far_t = torch.where(r_first, el, er)
        s = sp[act]
        rows = act[both]
        stack[rows, s[both]] = far[both]
        stack_t[rows, s[both]] = far_t[both]
        s = torch.where(both, s + 1, s)
        go = tl | tr
        node[act] = torch.where(go, near, n)
        # The rest pop until an entry below the best t, or the stack is empty.
        pop = ~go
        if any_hit:
            done = bi >= 0
            pop = pop & ~done
        else:
            done = torch.zeros_like(pop)
        while bool(pop.any()):
            has = pop & (s > 0)
            top = torch.clamp(s - 1, min=0)
            ent = stack_t[act, top]
            nxt = stack[act, top]
            s = torch.where(has, s - 1, s)
            take = has & (ent < best_t[act])
            node[act] = torch.where(take, nxt, node[act])
            done = done | (pop & ~has)
            pop = has & ~take
        sp[act] = s
        act = act[~done]
    hit = best >= 0
    out = (hit, torch.where(hit, best_t, t_max), best)
    return (*out, int(slabs), int(tests)) if counts else out

"""Ray-primitive intersection in torch (float32 throughout).

Counterpart of `rayfinder_tpu.render.intersect`:

* Moller-Trumbore with EPSILON = 1e-5 (src/common/ray_intersection.cpp:38-90,
  src/pt/reference_path_tracer.wgsl:477-521);
* slab ray-AABB test with precomputed inverse direction and per-axis
  direction signs (ray_intersection.cpp:92-136, wgsl:447-475);
* self-intersection avoidance by integer-mantissa ray offsetting
  (ray_intersection.cpp:17-35, wgsl:523-544).

Every dot and cross product is written out component by component, left to
right, in the order XLA evaluates `jnp.sum(..., -1)` and `jnp.cross`; the
CUDA kernels (csrc/traverse.cuh, traverse2.cuh) use the same order, so the
three agree to the bit. Vectors are (B, 3) tensors; `_x/_y/_z` helpers pick components.
"""

from __future__ import annotations

import torch

EPSILON = 1e-5
T_MIN = 1e-3
T_MAX = 1e4

_ORIGIN = 1.0 / 32.0
_FLOAT_SCALE = 1.0 / 65536.0
_INT_SCALE = 256.0


def dot(a, b):
    """Sum of products over the last axis, ((x + y) + z)."""
    p0, p1, p2 = (a * b).unbind(-1)
    return p0 + p1 + p2


def cross(a, b):
    """jnp.cross order: (a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 - a1 b0)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def to_int32(x):
    """float32 -> int32 toward zero, saturating, NaN -> 0: XLA's and CUDA's
    conversion (a bare `.to(torch.int32)` is undefined out of range)."""
    x = torch.where(torch.isnan(x), 0.0, x)
    i = x.clamp(-2147483648.0, 2147483520.0).to(torch.int32)
    return torch.where(x >= 2147483648.0, 2147483647, i)


def offset_ray(p, n, int_scale=_INT_SCALE, float_scale=_FLOAT_SCALE):
    """Scale-invariant surface offset along n (ray_intersection.cpp:17-35):
    an integer offset added straight into the float's bits, except near the
    origin, where a fixed epsilon is used instead."""
    offset = to_int32(int_scale * n)
    p_bits = p.view(torch.int32)
    po_bits = p_bits + torch.where(p < 0, -offset, offset)
    po = po_bits.view(torch.float32)
    return torch.where(torch.abs(p) < _ORIGIN, p + float_scale * n, po)


def ray_triangle(origin, direction, v0, v1, v2, t_max):
    """Moller-Trumbore single-hit test, elementwise over (..., 3) batches.

    Returns (hit, t, u, v): hit is bool; t/u/v are valid only where hit.
    Mirrors wgsl:477-521 (the barycentric b = (1-u-v, u, v))."""
    e1 = v1 - v0
    e2 = v2 - v0
    h = cross(direction, e2)
    det = dot(e1, h)
    inv_det = 1.0 / det
    s = origin - v0
    u = inv_det * dot(s, h)
    q = cross(s, e1)
    v = inv_det * dot(direction, q)
    t = inv_det * dot(e2, q)

    hit = (
        (torch.abs(det) >= EPSILON)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPSILON)
        & (t < t_max)
    )
    return hit, t, u, v


def _slab_terms(origin, inv_dir, dir_neg, aabb_min, aabb_max):
    """The terms of the slab test that do not depend on its bound: (tmin,
    tmax, fail_xy, fail_z)."""
    near = torch.where(dir_neg, aabb_max, aabb_min)
    far = torch.where(dir_neg, aabb_min, aabb_max)
    t0 = (near - origin) * inv_dir
    t1 = (far - origin) * inv_dir

    tmin_xy = torch.maximum(t0[..., 0], t0[..., 1])
    tmax_xy = torch.minimum(t1[..., 0], t1[..., 1])
    fail_xy = (t0[..., 0] > t1[..., 1]) | (t0[..., 1] > t1[..., 0])

    fail_z = (tmin_xy > t1[..., 2]) | (t0[..., 2] > tmax_xy)
    tmin = torch.maximum(tmin_xy, t0[..., 2])
    tmax = torch.minimum(tmax_xy, t1[..., 2])
    return tmin, tmax, fail_xy, fail_z


def ray_aabb(origin, inv_dir, dir_neg, aabb_min, aabb_max, t_max):
    """Slab test (ray_intersection.cpp:101-136). dir_neg is bool (..., 3).

    All three slabs are computed and combined with the reference's
    asymmetric </> comparisons, which gives the accept set of its
    early-out form."""
    tmin, tmax, fail_xy, fail_z = _slab_terms(origin, inv_dir, dir_neg, aabb_min, aabb_max)
    return ~fail_xy & ~fail_z & (tmin < t_max) & (tmax > 0.0)


def ray_aabb_entry(origin, inv_dir, dir_neg, aabb_min, aabb_max):
    """The slab test's entry distance: tmin where its bound-free terms pass,
    +inf elsewhere, so that `ray_aabb(..., t_max)` is `entry < t_max` for
    every t_max (the packed walk's stack key, csrc/traverse2.cuh)."""
    tmin, tmax, fail_xy, fail_z = _slab_terms(origin, inv_dir, dir_neg, aabb_min, aabb_max)
    return torch.where(~fail_xy & ~fail_z & (tmax > 0.0), tmin, torch.inf)


# Most ray-triangle pairs that brute_force_closest_hit evaluates at once: a
# chunk of rays x every triangle. Each (rays, triangles, 3) intermediate of
# a chunk is then at most 768 MiB.
BRUTE_FORCE_PAIRS = 1 << 26


def brute_force_closest_hit(origin, direction, triangles, t_max):
    """All-triangles closest hit: the oracle of the BVH traversal tests
    (counterpart of `rayfinder_tpu.render.intersect.brute_force_closest_hit`,
    pattern of src/tests/bvh.cpp:34-101).

    origin/direction: (R, 3); triangles: (T, 3, 3); t_max: a scalar.
    Returns (hit bool, t f32, tri_idx i32), each (R,): t_max and -1 where
    nothing is hit. On equal t the lowest triangle index wins (argmin's first
    minimum). Rays go in chunks of at most BRUTE_FORCE_PAIRS // T rays; each
    ray's arithmetic is elementwise, so the result is the one-shot
    evaluation's bit for bit."""
    chunk = max(1, BRUTE_FORCE_PAIRS // max(triangles.shape[0], 1))
    v0, v1, v2 = (triangles[None, :, k] for k in range(3))
    ts, tris = [], []
    for s in range(0, max(origin.shape[0], 1), chunk):
        hit, t, _, _ = ray_triangle(origin[s:s + chunk, None], direction[s:s + chunk, None],
                                    v0, v1, v2, t_max)
        t = torch.where(hit, t, torch.inf)
        tri = torch.argmin(t, dim=-1)
        ts.append(torch.gather(t, 1, tri[:, None])[:, 0])
        tris.append(tri)
    best_t, tri = torch.cat(ts), torch.cat(tris)
    hit = torch.isfinite(best_t)
    return hit, torch.where(hit, best_t, t_max), torch.where(hit, tri, -1).to(torch.int32)

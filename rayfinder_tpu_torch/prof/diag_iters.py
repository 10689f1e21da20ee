"""Traversal efficiency of the per-thread walk: the bench's mt_waste fields.

Counterpart of prof/diag_iters.py together with bench.py
_courtyard_efficiency. The bench camera's primary rays, then two cosine
bounces off the hit surfaces (np.random.default_rng(7)), each bounce
population ordered by the production dir key (parent hit cluster x 96
direction bins), as the JAX bench builds them, or (--order none) left in the
order of their parent rays, as the unsorted split route traces them. On
each population:

- K6 (ops/counted.py) walks every ray and counts its nodes visited, leaves
  entered and triangle tests;
- K7 (ops/slab.py) gives each ray's need: the triangles of the BVH leaves
  whose slab entry precedes the ray's true hit (t_max on a miss), which a
  front-to-back walk must test, plus the leaf of the hit triangle itself
  where its flat box is entered at t exactly (`need_of`).

mt_waste_<pop> = 100 (1 - need / issued), where issued sums, over warps of
32 consecutive rays (this card's lockstep unit, as the 128-lane tile is the
TPU's), 32 x the warp's largest triangle-test count; mt_waste_lane_<pop> =
100 (1 - need / the rays' own triangle tests). These are per leaf (at most 2
triangles) where the TPU's were per 128-triangle cluster: the two are not
comparable. Per ray, need <= triangle tests holds (a leaf entered before the
true hit is always tested); rays that break it are listed.

    python -m rayfinder_tpu_torch.prof.diag_iters [scale=26] [--device cuda|cpu] [--size 512]
        [--order dir|none]

On the CPU it runs the plain versions (use a small scale and size there).
"""

from __future__ import annotations

import argparse
import time
import types

import numpy as np
import torch

from ..bvh.clusters import triangle_clusters
from ..ops.counted import intersect_closest_counted
from ..ops.slab import slab_entry, slab_entry_reduce
from ..render.camera import create_camera, generate_camera_ray_lens
from ..render.intersect import T_MAX
from ..render.sampling import sample_cosine_hemisphere
from ..render.scene import DeviceScene

WARP = 32
# Boxes per K7 group (the TPU's super-cluster size); the efficiency figures
# use only `need`.
GROUP = 128


def cosine_bounce(scene: DeviceScene, on, dn, hitn, tn, trin, rng):
    """One cosine-hemisphere bounce off the hit surfaces (numpy, offline):
    returns (origins, directions, parent_tri) for the hit subset."""
    sp = scene.tri_positions.cpu().numpy()
    trin = np.maximum(trin, 0)
    p = on + tn[:, None] * dn
    v0, v1, v2 = sp[trin, 0], sp[trin, 1], sp[trin, 2]
    gn = np.cross(v1 - v0, v2 - v0)
    gn /= np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-12)
    gn = np.where((np.einsum("ij,ij->i", gn, dn) > 0)[:, None], -gn, gn)
    noise = rng.random((len(on), 2)).astype(np.float32)
    wi = sample_cosine_hemisphere(torch.from_numpy(noise), torch.from_numpy(gn)).numpy()
    return (p + 1e-3 * gn)[hitn], wi[hitn], trin[hitn]


def scene_tri_clusters(scene: DeviceScene) -> np.ndarray:
    """(T,) cluster of each leaf-order triangle under the JAX scene's rule
    (bvh/clusters.py), from the scene's own BVH."""
    bvh = types.SimpleNamespace(
        triangles_offset=scene.bvh_tri_offset.cpu().numpy(),
        second_child_offset=scene.bvh_second_child.cpu().numpy(),
        triangle_count=scene.bvh_tri_count.cpu().numpy(),
    )
    return triangle_clusters(bvh, scene.tri_positions.cpu().numpy())


def dir_key_order(tri_cluster: np.ndarray, dn, trih):
    """Production dir-key ordering (the JAX pathtracer's _dir_bin_key):
    parent hit cluster x 96 world-frame direction bins. tri_cluster (T,)
    maps a leaf-order triangle to its cluster."""
    hc = tri_cluster[trih]
    dd = dn
    ad = np.abs(dd)
    is_x = (ad[:, 0] >= ad[:, 1]) & (ad[:, 0] >= ad[:, 2])
    is_y = ~is_x & (ad[:, 1] >= ad[:, 2])
    m = np.maximum(ad.max(1), 1e-20)
    ds2 = np.where(is_x, dd[:, 0], np.where(is_y, dd[:, 1], dd[:, 2]))
    face = np.where(is_x, 0, np.where(is_y, 2, 4)) + (ds2 > 0)
    u2 = np.where(is_x, dd[:, 1], np.where(is_y, dd[:, 2], dd[:, 0]))
    v2 = np.where(is_x, dd[:, 2], np.where(is_y, dd[:, 0], dd[:, 1]))
    ub = np.clip(((u2 / m + 1.0) * 2.0).astype(np.int64), 0, 3)
    vb = np.clip(((v2 / m + 1.0) * 2.0).astype(np.int64), 0, 3)
    ck = hc * 96 + (face * 4 + ub) * 4 + vb
    return np.argsort(ck, kind="stable")


def waste(tests, need) -> dict:
    """The efficiency figures of one population from per-ray triangle tests
    and need (N,) integer arrays: warp-issued and lane-issued tests, need,
    and the two waste percentages."""
    tests = np.asarray(tests, np.int64)
    need = np.asarray(need, np.int64)
    pad = -tests.size % WARP
    warps = np.concatenate([tests, np.zeros(pad, np.int64)]).reshape(-1, WARP)
    issued_warp = int(WARP * warps.max(axis=1).sum())
    issued_lane = int(tests.sum())
    needed = int(need.sum())
    return dict(
        issued_warp=issued_warp, issued_lane=issued_lane, need=needed,
        mt_waste=100.0 * (1.0 - needed / max(issued_warp, 1)),
        mt_waste_lane=100.0 * (1.0 - needed / max(issued_lane, 1)),
    )


def leaf_boxes(scene: DeviceScene):
    """The BVH's leaves, in node order: (box_min, box_max (L, 3) f32,
    triangle count (L,) int32, first triangle (L,) int32). The builder
    flattens depth first, so the first triangles ascend."""
    leaf = torch.nonzero(scene.bvh_tri_count > 0)[:, 0]
    return (scene.bvh_aabb_min[leaf].contiguous(), scene.bvh_aabb_max[leaf].contiguous(),
            scene.bvh_tri_count[leaf].contiguous(), scene.bvh_tri_offset[leaf].contiguous())


def need_of(boxes, o, inv, hit, bound, tri):
    """Each ray's need: the triangles of the leaves whose slab entry precedes
    its hit (K7), plus the leaf that holds the hit triangle where K7 does
    not count it. That leaf must be tested to find the hit, but where its
    box is flat (a floor or wall leaf) its entry equals t, not less."""
    box_min, box_max, count, first = boxes
    need, _, _ = slab_entry_reduce(box_min, box_max, count, o, inv, bound, GROUP)
    own = torch.searchsorted(first, tri.clamp(min=0), right=True) - 1
    counted = slab_entry(box_min[own], box_max[own], o, inv, bound) < bound
    return need + torch.where(hit & ~counted, count[own], 0)


def primary_rays(camera, w: int, h: int, dev):
    """The bench's primary rays: pixel centres, v from the top, no lens
    sample. Returns (origin, direction) (w*h, 3)."""
    js, is_ = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    u = torch.from_numpy((js.reshape(-1) + 0.5).astype(np.float32) / w).to(dev)
    v = torch.from_numpy(1.0 - (is_.reshape(-1) + 0.5).astype(np.float32) / h).to(dev)
    o, d = generate_camera_ray_lens(camera, torch.zeros(w * h, 2, device=dev), u, v)
    return o.contiguous(), d.contiguous()


def measure(scene: DeviceScene, boxes, o, d, t_max: float = T_MAX) -> dict:
    """K6 and K7 on one population: per-ray hit, t, tri, counts, bound,
    need and the efficiency figures."""
    hit, t, tri, counts = intersect_closest_counted(scene, o, d, t_max)
    bound = torch.where(hit, t, torch.full_like(t, t_max)).contiguous()
    need = need_of(boxes, o, (1.0 / d).contiguous(), hit, bound, tri)
    counts_np, need_np = counts.cpu().numpy(), need.cpu().numpy()
    tests = counts_np[:, 2]
    figures = waste(tests, need_np)
    over = np.nonzero(need_np > tests)[0]
    return dict(o=o, d=d, hit=hit, t=t, tri=tri, counts=counts, bound=bound, need=need,
                figures=figures, need_over_tests=over,
                nodes_per_ray=float(counts_np[:, 0].mean()),
                leaves_per_ray=float(counts_np[:, 1].mean()),
                tests_per_ray=float(tests.mean()), need_per_ray=float(need_np.mean()),
                hit_fraction=float(hit.float().mean()))


def populations(scene: DeviceScene, camera, w: int, h: int, tri_cluster=None,
                order: str = "dir"):
    """Measure the primary, bounce-1 and bounce-2 populations in turn, the
    bounces ordered by the dir key (order="dir") or left in their parents'
    order ("none"). Yields (name, measure(...) result)."""
    if order not in ("dir", "none"):
        raise ValueError(f"order={order!r}: dir or none")
    dev = scene.device
    boxes = leaf_boxes(scene)
    if tri_cluster is None:
        tri_cluster = scene_tri_clusters(scene)
    o, d = primary_rays(camera, w, h, dev)
    r = measure(scene, boxes, o, d)
    yield "primary", r
    rng = np.random.default_rng(7)
    on, dn = o.cpu().numpy(), d.cpu().numpy()
    for b in (1, 2):
        on, dn, trih = cosine_bounce(scene, on, dn, r["hit"].cpu().numpy(),
                                     r["t"].cpu().numpy(), r["tri"].cpu().numpy(), rng)
        if order == "dir":
            perm = dir_key_order(tri_cluster, dn, trih)
            on, dn = on[perm], dn[perm]
        r = measure(scene, boxes, torch.from_numpy(np.ascontiguousarray(on)).to(dev),
                    torch.from_numpy(np.ascontiguousarray(dn)).to(dev))
        yield f"bounce{b}", r


def traversal_efficiency(scene: DeviceScene, camera, w: int, h: int) -> dict:
    """The mt_waste_<pop> and mt_waste_lane_<pop> fields for the primary,
    bounce-1 and bounce-2 populations, with the per-ray means of nodes,
    triangle tests and need."""
    return efficiency_fields(dict(populations(scene, camera, w, h)))


def efficiency_fields(results: dict) -> dict:
    """The fields of traversal_efficiency from {population: measure(...)}."""
    fields = {}
    for name, r in results.items():
        f = r["figures"]
        fields[f"mt_waste_{name}"] = f["mt_waste"]
        fields[f"mt_waste_lane_{name}"] = f["mt_waste_lane"]
        for key in ("nodes_per_ray", "tests_per_ray", "need_per_ray"):
            fields[f"{key}_{name}"] = r[key]
        fields[f"need_over_tests_{name}"] = r["need_over_tests"].tolist()
    return fields


def report(name: str, r: dict) -> str:
    f = r["figures"]
    return (f"{name:>8}: rays {r['o'].shape[0]} hit {r['hit_fraction']:.4f} nodes/ray "
            f"{r['nodes_per_ray']:.2f} leaves/ray {r['leaves_per_ray']:.2f} tests/ray "
            f"{r['tests_per_ray']:.2f} need/ray {r['need_per_ray']:.2f} mt_waste "
            f"{f['mt_waste']:.2f}% (warp) {f['mt_waste_lane']:.2f}% (lane); rays with "
            f"need > tests: {r['need_over_tests'].tolist()}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("scale", type=int, nargs="?", default=26)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--size", type=int, default=512, help="primary rays per side")
    ap.add_argument("--order", default="dir", choices=("dir", "none"),
                    help="bounce rays sorted by the dir key (default) or in their parents' order")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("diag_iters: no CUDA device (pass --device cpu for the plain versions)")
    from .scenes import BENCH_CAMERA, courtyard_pt_scene

    scene, info = courtyard_pt_scene(args.scale, device=args.device)
    print(f"courtyard_scene({args.scale}) from {info['path']}: {scene.num_triangles} tris, "
          f"{scene.num_nodes} nodes, {int((scene.bvh_tri_count > 0).sum())} leaves "
          f"[{args.device}]", flush=True)
    camera = create_camera(*BENCH_CAMERA, 1.0)
    t0 = time.perf_counter()
    print(f"bounce order: {args.order}", flush=True)
    for name, r in populations(scene, camera, args.size, args.size, order=args.order):
        print(report(name, r), flush=True)
    print(f"took {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()

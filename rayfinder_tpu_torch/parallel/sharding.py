"""Multi-GPU rendering: tiles x samples over torch.distributed.

Counterpart of `rayfinder_tpu.parallel.sharding`, with one process per rank
where JAX has one program over a device mesh:

* a **tiles** axis: pixels are sharded across ranks (no communication), and
* a **samples** axis: each rank traces a share of the step's samples for its
  pixel shard, and the partial radiances are summed with one `all_reduce`
  over the rank's samples group per step (JAX's `psum`).

Ranks are laid out as `np.reshape(ranks, (tiles, samples))`: rank = tile x
samples + sample. A mesh spans the world, or the ranks of a process group
passed as `group` (JAX's `devices`); every rank of the world makes it. Each
rank holds its own tile shard of the accumulator, `P_padded / tiles` rows,
P_padded being width x height rounded up to a multiple of the tile count.
Sample rank r of a step traces the frames that follow the step's frame_base
by r times its share, so sample s of pixel p has the same noise whichever
rank traces it. The image is assembled with one `all_reduce` over the
mesh's ranks of a (P_padded, 3) buffer into which only sample rank 0 of
each tile writes its shard, and every rank returns the same (H, W, 3)
image.

The caller initialises the process group and chooses its backend: `nccl`
for one rank per card, `gloo` for CPU tensors and for several ranks that
share one card (Gloo serves `all_reduce` and `broadcast` on CUDA tensors,
the only collectives used here). A backend that cannot serve the rank's
device raises (check_backend), and so does `nccl` with two ranks on one
card; nothing switches backend by itself. A rank renders only on the device
its mesh names: `cuda:{LOCAL_RANK % device_count}` unless the caller passes
`device=`; a scene or accumulator elsewhere raises.

    torch.distributed.init_process_group("nccl", init_method=..., rank=r, world_size=n)
    mesh = make_render_mesh(sample_parallel=2)
    scene = build_device_scene(flat, device=mesh.device)
    img = render_image_sharded_regen(scene, sky, camera, mesh=mesh, width=w,
                                     height=h, spp=64, num_bounces=4)

Engines: "kernel" (the JAX "pallas": the fused loop per shard for the
`_regen` pair, K1/K2 for the scan form), "plain", "kernel_split",
"reference", "wavefront", with the JAX defaults: "wavefront" for
render_step_sharded and render_image_sharded, "kernel" for the `_regen`
pair.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..render.camera import Camera
from ..render.pathtracer import _scan_frames, accumulate_lanes_regen
from ..render.rng import blue_noise_tile
from ..render.scene import DeviceScene
from ..render.tiling import block_order, unswizzle
from ..render.tonemap import tonemap
from ..sky.model import SkyState

__all__ = [
    "RenderMesh", "check_backend", "make_render_mesh", "render_step_sharded",
    "render_step_sharded_regen", "render_image_sharded", "render_image_sharded_regen",
]


@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """This rank's place in a (tiles, samples) mesh of ranks."""

    shape: dict  # {"tiles": t, "samples": s}
    tile_rank: int
    sample_rank: int
    device: torch.device  # the device this rank renders on
    group: object  # the mesh's process group (None: the whole world)
    samples_group: object  # this rank's samples group


def check_backend(backend: str, device) -> None:
    """Raise unless the distributed backend can serve tensors on `device`:
    NCCL serves CUDA tensors only, Gloo CPU and CUDA tensors (all_reduce and
    broadcast)."""
    device = torch.device(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: the sharded render runs on nccl or gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend serves CUDA tensors only, not {device}: use gloo")


def _rank_device(device):
    """The rank's device: `device` when given, else cuda:{LOCAL_RANK %
    device_count}. A CUDA device without an index gets the current one."""
    if device is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device: pass device= (e.g. 'cpu' with the gloo backend)")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % count)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


# The backends a mesh runs on, by their code in _world_rows.
_BACKENDS = ("gloo", "nccl")


def _world_rows(row) -> torch.Tensor:
    """Every world rank's (5,) int64 row, met in one all_reduce over a Gloo
    group of the whole world, on the host (so no NCCL communicator is made
    first); a rank outside the mesh gives zeros. Every rank of the world
    must call it."""
    side = dist.new_group(backend="gloo")
    table = torch.zeros(dist.get_world_size(), row.shape[0], dtype=torch.int64)
    table[dist.get_rank()] = row
    dist.all_reduce(table, group=side)
    dist.destroy_process_group(side)
    return table


def _card_words(device: torch.device) -> torch.Tensor:
    """The card's UUID as four 32-bit words."""
    uuid = str(torch.cuda.get_device_properties(device).uuid).replace("-", "")
    return torch.tensor([int(uuid[i:i + 8], 16) for i in range(0, 32, 8)])


def _one_rank_per_card(table: torch.Tensor, ranks: list[int], device) -> None:
    """NCCL takes one rank per card: raise, on every rank, where two of
    `ranks` render on the same card (equal UUID words in `table`), naming
    the card on the ranks that share it."""
    cards = [tuple(table[r, 1:].tolist()) for r in ranks]
    shared = [r for r, card in zip(ranks, cards) if cards.count(card) > 1]
    if shared:
        card = "" if device is None else (f" share {torch.cuda.get_device_name(device)} "
                                          f"({device})")
        raise ValueError(f"the nccl backend takes one rank per card: ranks {shared}{card}; "
                         "use gloo")


def make_render_mesh(sample_parallel: int | None = None, group=None,
                     device=None) -> RenderMesh | None:
    """This rank's (tiles, samples) mesh over the ranks of `group`, a process
    group of the initialised world (all of it when None): the i-th of those
    ranks by world rank is tile i // samples, sample i % samples.
    sample_parallel defaults to 2 when the mesh has an even number of ranks
    larger than 1, else 1. Every rank of the world calls it with the same
    arguments, in the same order, members of `group` or not: each enters
    every process group it makes. A rank outside `group` gets None."""
    if not dist.is_initialized():
        raise RuntimeError("make_render_mesh needs an initialised torch.distributed process group")
    row = torch.zeros(5, dtype=torch.int64)
    member = dist.get_rank(group) >= 0
    if member:
        backend = dist.get_backend(group)
        device = _rank_device(device)
        check_backend(backend, device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        row[0] = 1 + _BACKENDS.index(backend)
        if backend == "nccl":
            row[1:] = _card_words(device)
    table = _world_rows(row)
    ranks = torch.nonzero(table[:, 0])[:, 0].tolist()
    backend = _BACKENDS[int(table[ranks[0], 0]) - 1]
    size = len(ranks)
    if sample_parallel is None:
        sample_parallel = 2 if size % 2 == 0 and size > 1 else 1
    if sample_parallel < 1 or size % sample_parallel:
        raise ValueError(f"sample_parallel={sample_parallel} does not divide the mesh's "
                         f"{size} ranks")
    if backend == "nccl":
        _one_rank_per_card(table, ranks, device if member else None)
    tiles = size // sample_parallel
    rank = ranks.index(dist.get_rank()) if member else -1
    samples_group = None
    for t in range(tiles):
        g = dist.new_group(ranks[t * sample_parallel:(t + 1) * sample_parallel], backend=backend)
        if t == rank // sample_parallel:
            samples_group = g
    if not member:
        return None
    return RenderMesh(shape={"tiles": tiles, "samples": sample_parallel},
                      tile_rank=rank // sample_parallel, sample_rank=rank % sample_parallel,
                      device=device, group=group, samples_group=samples_group)


def _on_mesh_device(mesh: RenderMesh, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != mesh.device:
            raise ValueError(f"{name} is on {t.device}; this rank renders on {mesh.device}")


def _sum_samples(mesh: RenderMesh, partial):
    """The step's radiance summed over the samples axis (JAX's psum)."""
    if mesh.shape["samples"] > 1:
        dist.all_reduce(partial, group=mesh.samples_group)
    return partial


def _padded(mesh: RenderMesh, width: int, height: int) -> int:
    tiles = mesh.shape["tiles"]
    return -(-width * height // tiles) * tiles


def _shard(mesh: RenderMesh, full):
    """This rank's tile rows of a (P_padded, ...) tensor."""
    rows = full.shape[0] // mesh.shape["tiles"]
    return full[mesh.tile_rank * rows:(mesh.tile_rank + 1) * rows]


def _assemble(mesh: RenderMesh, accum, padded: int):
    """The (P_padded, 3) accumulator of every tile, on every rank: sample
    rank 0 of each tile writes its shard into zeros and one all_reduce over
    the mesh's ranks sums them (each row has one writer, so the sum is exact)."""
    if mesh.shape["tiles"] * mesh.shape["samples"] == 1:
        return accum
    full = torch.zeros(padded, 3, device=accum.device)
    if mesh.sample_rank == 0:
        _shard(mesh, full).copy_(accum)
    dist.all_reduce(full, group=mesh.group)
    return full


def render_step_sharded(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    blue_noise_tile,
    frame_base: int,
    accum,
    *,
    mesh: RenderMesh,
    width: int,
    height: int,
    num_bounces: int,
    spp: int,
    engine: str = "wavefront",
):
    """One sharded progressive step of the scan form: adds samples_axis
    samples per pixel, sample rank r tracing frame frame_base + r. Pixels
    are in row-major order. accum: this rank's (P_padded / tiles, 3) shard.
    Returns the new shard."""
    _on_mesh_device(mesh, scene=scene.tri_positions, accum=accum, blue_noise_tile=blue_noise_tile)
    padded = accum.shape[0] * mesh.shape["tiles"]
    pix = _shard(mesh, torch.arange(padded, device=accum.device))
    pix = torch.where(pix < width * height, pix, 0)  # padding rows render pixel 0
    ys, xs = (pix // width).to(torch.int32), (pix % width).to(torch.int32)
    radiance = _scan_frames(scene, sky, camera, blue_noise_tile, frame_base + mesh.sample_rank,
                            torch.zeros_like(accum), ys, xs, width=width, height=height,
                            num_bounces=num_bounces, spp=spp, num_frames=1, engine=engine)
    return accum + _sum_samples(mesh, radiance)


def render_step_sharded_regen(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    blue_noise_tile,
    frame_base: int,
    accum,
    *,
    mesh: RenderMesh,
    width: int,
    height: int,
    num_bounces: int,
    spp: int,
    num_frames: int,
    engine: str = "kernel",
):
    """One sharded step of the regeneration loop: every rank runs the
    single-device loop (accumulate_lanes_regen, on "kernel" its default
    route: the dispatch inside K4) over its pixel shard, tracing
    num_frames / samples_axis consecutive samples from frame_base + sample
    rank x that share, from a zero partial; the samples axis then sums the
    partials. Pixels are in block-major order (render/tiling.block_order),
    so each shard holds whole pixel blocks. accum: this rank's block-ordered
    (P_padded / tiles, 3) shard. Returns the new shard.

    Per pixel, the partials and their sum group the samples differently
    from one device's loop, so the sums can differ by f32 ulps; on a 1x1
    mesh from a zero accumulator they do not."""
    _on_mesh_device(mesh, scene=scene.tri_positions, accum=accum, blue_noise_tile=blue_noise_tile)
    samples = mesh.shape["samples"]
    if num_frames % samples:
        raise ValueError(f"num_frames={num_frames} is not a multiple of the samples axis "
                         f"({samples})")
    nf_local = num_frames // samples
    padded = accum.shape[0] * mesh.shape["tiles"]
    ys_np, xs_np, _ = block_order(width, height)
    pad = padded - width * height
    ys = _shard(mesh, torch.from_numpy(np.pad(ys_np, (0, pad))).to(accum.device))
    xs = _shard(mesh, torch.from_numpy(np.pad(xs_np, (0, pad))).to(accum.device))
    u = (xs.to(torch.float32) + 0.5) / float(width)
    v_tex = (ys.to(torch.float32) + 0.5) / float(height)
    th, tw = blue_noise_tile.shape[0], blue_noise_tile.shape[1]
    noise_base = blue_noise_tile[(ys % th).long(), (xs % tw).long()]
    inv_dims = (float(np.float32(1.0) / np.float32(width)),
                float(np.float32(1.0) / np.float32(height)))
    partial = accumulate_lanes_regen(
        scene, sky, camera, frame_base + mesh.sample_rank * nf_local, torch.zeros_like(accum),
        u, v_tex, noise_base, inv_dims, num_bounces=num_bounces, spp=spp,
        num_frames=nf_local, engine=engine)
    return accum + _sum_samples(mesh, partial)


def render_image_sharded_regen(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    *,
    mesh: RenderMesh,
    width: int,
    height: int,
    spp: int,
    num_bounces: int,
    exposure: float = 1.0,
    engine: str = "kernel",
    samples_per_dispatch: int | None = None,
) -> np.ndarray:
    """A full sharded render through the regeneration loop
    (render_step_sharded_regen), samples_per_dispatch samples per step
    (rounded down to a multiple of the samples axis; all of spp when None).
    Returns the (H, W, 3) float32 image, on every rank."""
    samples = mesh.shape["samples"]
    if spp % samples:
        raise ValueError(f"spp={spp} is not a multiple of the samples axis ({samples})")
    spd = samples_per_dispatch or spp
    spd = max(samples, (spd // samples) * samples)
    padded = _padded(mesh, width, height)
    accum = torch.zeros(padded // mesh.shape["tiles"], 3, device=mesh.device)
    tile = torch.from_numpy(blue_noise_tile()).to(mesh.device)
    frame_base = 0
    while frame_base < spp:
        n = min(spd, spp - frame_base)
        accum = render_step_sharded_regen(
            scene, sky, camera, tile, frame_base, accum, mesh=mesh, width=width,
            height=height, num_bounces=num_bounces, spp=spp, num_frames=n, engine=engine)
        frame_base += n
    full = _assemble(mesh, accum, padded)
    img = tonemap(unswizzle(full[:width * height], width, height) / float(spp), exposure)
    return img.reshape(height, width, 3).cpu().numpy()


def render_image_sharded(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    *,
    mesh: RenderMesh,
    width: int,
    height: int,
    spp: int,
    num_bounces: int,
    exposure: float = 1.0,
    engine: str = "wavefront",
) -> np.ndarray:
    """A full sharded render through the scan form: progressive steps of
    samples_axis samples (render_step_sharded), running-mean estimator,
    ACES tonemap. Returns the (H, W, 3) float32 image, on every rank."""
    samples = mesh.shape["samples"]
    if spp % samples:
        raise ValueError(f"spp={spp} is not a multiple of the samples axis ({samples})")
    padded = _padded(mesh, width, height)
    accum = torch.zeros(padded // mesh.shape["tiles"], 3, device=mesh.device)
    tile = torch.from_numpy(blue_noise_tile()).to(mesh.device)
    for frame_base in range(0, spp, samples):
        accum = render_step_sharded(
            scene, sky, camera, tile, frame_base, accum, mesh=mesh, width=width,
            height=height, num_bounces=num_bounces, spp=spp, engine=engine)
    full = _assemble(mesh, accum, padded)
    img = tonemap(full[:width * height] / float(spp), exposure)
    return img.reshape(height, width, 3).cpu().numpy()

"""Pixel swizzling: hierarchical block-major ray order.

Counterpart of `rayfinder_tpu.render.tiling`: pixels are laid out as 32x16
blocks whose interiors are four 16x8 sub-blocks, so neighbouring lanes trace
neighbouring pixels. The path tracer generates, shades and accumulates in
block order and unswizzles once when the image is assembled.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import profiling

SUB_W = 16
SUB_H = 8
_SUBDIV = 2
BLOCK_W = SUB_W * _SUBDIV
BLOCK_H = SUB_H * _SUBDIV


def _span_order(x0: int, y0: int, w: int, h: int):
    """Pixel coords covering [x0,x0+w) x [y0,y0+h) as whole 16x8 sub-blocks
    (row-major inside each), clamped at the span edges."""
    ys_out, xs_out = [], []
    for sy in range(y0, y0 + h, SUB_H):
        for sx in range(x0, x0 + w, SUB_W):
            hh = min(SUB_H, y0 + h - sy)
            ww = min(SUB_W, x0 + w - sx)
            yy, xx = np.meshgrid(
                np.arange(sy, sy + hh), np.arange(sx, sx + ww), indexing="ij"
            )
            ys_out.append(yy.reshape(-1))
            xs_out.append(xx.reshape(-1))
    return ys_out, xs_out


@functools.lru_cache(maxsize=8)
def block_order(width: int, height: int):
    """Returns (ys, xs, pixel_idx): pixel coordinates in hierarchical
    block-major order and the flat row-major pixel index of each position
    (all (H*W,) int32 numpy arrays)."""
    ys_out = []
    xs_out = []
    for by in range(0, height, BLOCK_H):
        for bx in range(0, width, BLOCK_W):
            h = min(BLOCK_H, height - by)
            w = min(BLOCK_W, width - bx)
            ys, xs = _span_order(bx, by, w, h)
            ys_out.extend(ys)
            xs_out.extend(xs)
    ys = np.concatenate(ys_out).astype(np.int32)
    xs = np.concatenate(xs_out).astype(np.int32)
    return ys, xs, (ys.astype(np.int64) * width + xs).astype(np.int32)


def block_order_on(width: int, height: int, device):
    """block_order's (ys, xs, pixel_idx) as tensors on `device`: ys and xs
    int32, pixel_idx int64 (the scatter's index). Built and uploaded once per
    (width, height, device) and kept; read-only, so no caller writes into
    them."""
    return _block_order_on(width, height, torch.device(device))


@functools.lru_cache(maxsize=8)
def _block_order_on(width: int, height: int, device: torch.device):
    ys, xs, pixel_idx = block_order(width, height)
    idx = pixel_idx.astype(np.int64)
    profiling.count(profiling.PIXEL_TABLES, 1)
    profiling.count(profiling.H2D_BYTES, ys.nbytes + xs.nbytes + idx.nbytes)
    # torch.tensor copies, so the CPU's tensors do not share block_order's arrays.
    return tuple(torch.tensor(a, device=device) for a in (ys, xs, idx))


def pixel_centres(ys, xs, width: int, height: int):
    """(u, v_tex): the float32 centres (x + 0.5) / width and (y + 0.5) /
    height of the pixels (ys, xs)."""
    return ((xs.to(torch.float32) + 0.5) / float(width),
            (ys.to(torch.float32) + 0.5) / float(height))


def pixel_lanes(width: int, height: int, tile, rows: int | None = None):
    """A dispatch's lanes over every pixel of a width x height image, in
    block order, from the cached tables on the blue-noise tile's device:
    (u, v_tex, noise_base, inv_dims). u and v_tex are pixel_centres,
    noise_base (P, 2) each pixel's value of `tile` (the base that every
    sample's noise offsets), inv_dims 1 / width and 1 / height as float32
    values. With `rows` the lanes are padded to that many rows, each padding
    row at pixel (0, 0). Made per call on the device: nothing is copied
    from the host after the tables' one upload."""
    ys, xs, _ = block_order_on(width, height, tile.device)
    if rows is not None and rows > ys.shape[0]:
        pad = ys.new_zeros(rows - ys.shape[0])
        ys, xs = torch.cat([ys, pad]), torch.cat([xs, pad])
    u, v_tex = pixel_centres(ys, xs, width, height)
    noise_base = tile[(ys % tile.shape[0]).long(), (xs % tile.shape[1]).long()]
    inv_dims = (float(np.float32(1.0) / np.float32(width)),
                float(np.float32(1.0) / np.float32(height)))
    return u, v_tex, noise_base, inv_dims


def unswizzle(flat_block_ordered, width: int, height: int):
    """(H*W, ...) block-ordered tensor -> row-major flat order."""
    _, _, idx = block_order_on(width, height, flat_block_ordered.device)
    out = torch.empty_like(flat_block_ordered)
    out[idx] = flat_block_ordered
    return out

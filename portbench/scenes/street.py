"""An exterior street at production scale: the benchmark's stand-in for a
scene like Amazon Lumberyard Bistro's Exterior, whose files are not in the
repository.

An open street, `length` metres long and 40 m between its facades, under the
sky: buildings of 2-4 storeys on both sides (recessed windows with frames
and sills, balconies with railings, string courses, cornices on brackets,
awnings over the shop fronts, wall lanterns), raised sidewalks with kerbs,
and props on the street: cafe terraces (round tables, chairs, parasols),
planters, street lamps and bollards. Every prop is placed, turned and scaled
from the seed, and is tessellated at `detail` (1.0: 200-5,000 triangles a
prop), so that triangle areas run from a roof's tens of square metres to a
chair leg's fraction of a square centimetre. The base colours are `textures`
maps of `texture_size` squared RGBA8 texels, each shared by several objects.

`make(seed, length, detail, textures, texture_size)` returns the flat
triangle soup and the textures as plain numpy arrays, as scenes/courtyard.py
does: the harness hands them to the program's asset path, and the reference
renders from them directly. The same arguments give the same scene, bit for
bit. `plan(...)` lists the objects and `census(...)` counts their triangles
without making any, by the same code (the builders run in a counting mode).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from .courtyard import Scene, Texture

HALF_WIDTH = 20.0  # the facades stand at z = +-20
SIDEWALK = 4.0
KERB = 0.15
GROUND_STOREY = 4.2
STOREY = 3.5
RECESS = 0.25  # depth of a window's reveal
ROOF_DEPTH = 12.0

# The texture groups: (first map, maps) of each group, as shares of the maps.
GROUPS = ("ground", "wall", "glass", "stone", "metal", "wood", "weave", "stripes", "canvas",
          "terracotta", "foliage")
_SHARES = (4, 16, 4, 6, 4, 6, 4, 4, 4, 2, 2)  # of 56


class Obj(NamedTuple):
    """One placed object: a builder's name, its place on the street, its turn
    about +y (radians) and scale, and its own draws (`k` seeds them)."""

    kind: str
    x: float
    y: float
    z: float
    angle: float
    scale: float
    k: int
    args: tuple


def _groups(textures: int) -> dict:
    """{group: (first map, number of maps)}: the maps split by _SHARES."""
    counts = [max(1, round(s * textures / sum(_SHARES))) for s in _SHARES]
    counts[1] += textures - sum(counts)
    if min(counts) < 1:
        raise ValueError(f"{textures} maps cannot hold the {len(GROUPS)} groups")
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return {g: (int(f), int(n)) for g, f, n in zip(GROUPS, first, counts)}


# ---- the builders' primitives ------------------------------------------------


class _Mesh:
    """Collects one object's triangles in its own frame, or, counting, only
    how many there would be. Every primitive faces outward: a triangle
    (a, b, c) faces along (b - a) x (c - a)."""

    def __init__(self, counting: bool, groups: dict, detail: float, seed: int):
        self.counting = counting
        self.seed = int(seed) % 2**64
        self.groups = groups
        self.detail = detail
        self.n = 0
        self.pos: list = []
        self.uv: list = []
        self.picks: list = []  # (triangles, group, k) of each primitive, in order
        self.pick = ("ground", 0)
        self.materials: set = set()

    def use(self, group: str, k: int) -> None:
        """The map of the primitives that follow: the group's k-th, cyclically."""
        self.pick = (group, k)

    def _emit(self, tris: int) -> None:
        group, k = self.pick
        first, count = self.groups[group]
        self.n += tris
        self.materials.add(first + k % count)
        self.picks.append((tris, group, k))

    def seg(self, base: float, least: int = 3) -> int:
        """A tessellation count: `base` at detail 1."""
        return max(least, int(round(base * self.detail)))

    def _grid(self, fn, nu: int, nv: int, uv_size) -> None:
        """The (nu x nv)-cell parametric patch fn(u, v) over [0, 1]^2; it faces
        along dP/du x dP/dv."""
        tris = 2 * nu * nv
        self._emit(tris)
        if self.counting:
            return
        u = np.linspace(0.0, 1.0, nu + 1)
        v = np.linspace(0.0, 1.0, nv + 1)
        uu, vv = np.meshgrid(u, v, indexing="ij")
        p = fn(uu, vv)  # (nu + 1, nv + 1, 3)
        t = np.stack([uu * uv_size[0], vv * uv_size[1]], axis=-1)

        def corners(a):
            a00, a10 = a[:-1, :-1].reshape(-1, a.shape[-1]), a[1:, :-1].reshape(-1, a.shape[-1])
            a01, a11 = a[:-1, 1:].reshape(-1, a.shape[-1]), a[1:, 1:].reshape(-1, a.shape[-1])
            return np.concatenate([np.stack([a00, a10, a11], 1), np.stack([a00, a11, a01], 1)])

        self.pos.append(corners(p))
        self.uv.append(corners(t))

    def quad(self, corner, eu, ev, density: float, tile: float = 2.0) -> None:
        """corner + u eu + v ev, cut into cells of about 1/density metres."""
        c, a, b = (np.asarray(x, np.float64) for x in (corner, eu, ev))
        la, lb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
        nu = max(1, int(round(la * density * self.detail)))
        nv = max(1, int(round(lb * density * self.detail)))
        self._grid(lambda u, v: c + u[..., None] * a + v[..., None] * b, nu, nv,
                   (la / tile, lb / tile))

    def box(self, center, half, density: float, tile: float = 1.0) -> None:
        """An axis-aligned box of six quads."""
        cx, cy, cz = center
        hx, hy, hz = half
        x0, y0, z0 = cx - hx, cy - hy, cz - hz
        X, Y, Z = (2 * hx, 0, 0), (0, 2 * hy, 0), (0, 0, 2 * hz)
        for corner, eu, ev in (((cx + hx, y0, z0), Y, Z), ((x0, y0, z0), Z, Y),
                               ((x0, cy + hy, z0), Z, X), ((x0, y0, z0), X, Z),
                               ((x0, y0, cz + hz), X, Y), ((x0, y0, z0), Y, X)):
            self.quad(corner, eu, ev, density, tile)

    def cylinder(self, base, radius: float, height: float, seg: int, rings: int,
                 caps: bool = True, top_radius: float | None = None) -> None:
        """A vertical cylinder (a cone frustum with top_radius) on `base`,
        with fan caps."""
        bx, by, bz = base
        r1 = radius if top_radius is None else top_radius

        def side(h, a):
            r = radius + (r1 - radius) * h
            ang = 2.0 * math.pi * a
            return np.stack([bx + r * np.cos(ang), by + height * h + 0 * a,
                             bz + r * np.sin(ang)], axis=-1)

        self._grid(side, rings, seg, (height, 2.0 * math.pi * radius))
        if caps:
            self._fan((bx, by + height, bz), r1, seg, up=True)
            self._fan((bx, by, bz), radius, seg, up=False)

    def _fan(self, center, radius: float, seg: int, up: bool) -> None:
        self._emit(seg)
        if self.counting:
            return
        ang = 2.0 * math.pi * np.arange(seg + 1) / seg
        ring = np.stack([center[0] + radius * np.cos(ang), np.full(seg + 1, center[1]),
                         center[2] + radius * np.sin(ang)], axis=-1)
        c = np.broadcast_to(np.asarray(center, np.float64), (seg, 3))
        a, b = (ring[1:], ring[:-1]) if up else (ring[:-1], ring[1:])
        self.pos.append(np.stack([c, a, b], axis=1))
        uvr = np.stack([0.5 + 0.5 * np.cos(ang), 0.5 + 0.5 * np.sin(ang)], axis=-1)
        ua, ub = (uvr[1:], uvr[:-1]) if up else (uvr[:-1], uvr[1:])
        self.uv.append(np.stack([np.full((seg, 2), 0.5), ua, ub], axis=1))

    def sphere(self, center, radius: float, seg: int, rings: int, bumps: float = 0.0,
               k: int = 0) -> None:
        """A UV sphere, open by a hair at the poles, its radius moved by up to
        `bumps` of itself (a shrub's crown; `k` draws the bumps)."""
        cx, cy, cz = center
        phase = (np.random.default_rng([self.seed, k, 7]).uniform(0, 2 * math.pi, 3)
                 if bumps else None)

        def surf(a, b):
            phi = 2.0 * math.pi * a
            th = 0.02 + (math.pi - 0.04) * b
            r = radius
            if bumps:
                r = radius * (1.0 + bumps * (np.sin(5 * phi + phase[0]) * np.sin(4 * th + phase[1])
                                             + 0.5 * np.sin(11 * phi + 9 * th + phase[2])) / 1.5)
            return np.stack([cx + r * np.sin(th) * np.cos(phi), cy + r * np.cos(th),
                             cz + r * np.sin(th) * np.sin(phi)], axis=-1)

        self._grid(surf, seg, rings, (2.0 * math.pi * radius, math.pi * radius))

    def canopy(self, apex, radius: float, drop: float, seg: int, rings: int,
               thickness: float = 0.01) -> None:
        """A parasol's cone, two-sided: its top and, `thickness` below, its
        underside."""
        ax, ay, az = apex

        def cone(dy, flip):
            def surf(a, s):
                phi = 2.0 * math.pi * (1.0 - a if flip else a)
                t = 0.03 + 0.97 * s
                return np.stack([ax + t * radius * np.cos(phi), ay - dy - t * drop + 0 * a,
                                 az + t * radius * np.sin(phi)], axis=-1)
            return surf

        self._grid(cone(0.0, False), seg, rings, (2.0 * math.pi * radius, radius))
        self._grid(cone(thickness, True), seg, rings, (2.0 * math.pi * radius, radius))

    def sheet(self, corner, eu, ev, density: float, thickness: float, tile: float = 1.0) -> None:
        """A two-sided sheet: the quad facing eu x ev, and behind it, by
        `thickness`, its reverse."""
        c, a, b = (np.asarray(x, np.float64) for x in (corner, eu, ev))
        n = np.cross(a, b)
        n = n / np.linalg.norm(n)
        self.quad(c, a, b, density, tile)
        self.quad(c - thickness * n, b, a, density, tile)


# ---- the objects -------------------------------------------------------------


def _building(m: _Mesh, o: Obj) -> None:
    """A building whose facade lies in z = 0 of its frame, facing +z, from
    x = 0 to its width; the street side of a roof block ROOF_DEPTH deep."""
    width, storeys, first_wall = o.args
    rng = np.random.default_rng([m.seed, o.k, 1])
    bays = max(2, int(round(width / 2.6)))
    bw = width / bays
    wall, d = int(first_wall), 7.0
    y0 = 0.0
    for s in range(storeys):
        hs = GROUND_STOREY if s == 0 else STOREY
        shop = s == 0
        ww = (0.62 if shop else 0.46) * bw
        wh = (0.66 if shop else 0.52) * hs
        sill = y0 + (0.35 if shop else 0.95)
        for b in range(bays):
            x0 = b * bw
            wx = x0 + (bw - ww) / 2
            m.use("wall", wall + s)
            # The wall round the opening, then the opening's reveal.
            m.quad((x0, y0, 0), (bw, 0, 0), (0, sill - y0, 0), d)
            m.quad((x0, sill + wh, 0), (bw, 0, 0), (0, y0 + hs - sill - wh, 0), d)
            m.quad((x0, sill, 0), (wx - x0, 0, 0), (0, wh, 0), d)
            m.quad((wx + ww, sill, 0), (x0 + bw - wx - ww, 0, 0), (0, wh, 0), d)
            m.quad((wx, sill, -RECESS), (0, wh, 0), (0, 0, RECESS), d)
            m.quad((wx + ww, sill, -RECESS), (0, 0, RECESS), (0, wh, 0), d)
            m.quad((wx, sill, -RECESS), (0, 0, RECESS), (ww, 0, 0), d)
            m.quad((wx, sill + wh, -RECESS), (ww, 0, 0), (0, 0, RECESS), d)
            m.use("glass", o.k + b)
            m.quad((wx, sill, -RECESS), (ww, 0, 0), (0, wh, 0), 2.0)
            m.use("metal", o.k + s)
            m.box((wx + ww / 2, sill + wh / 2, 0.03 - RECESS), (0.03, wh / 2, 0.03), 8.0)
            m.box((wx + ww / 2, sill + 0.65 * wh, 0.03 - RECESS), (ww / 2, 0.03, 0.03), 8.0)
            m.use("stone", o.k)
            if not shop:
                m.box((wx + ww / 2, sill - 0.05, 0.08), (ww / 2 + 0.1, 0.05, 0.1), 6.0)
                if rng.uniform() < 0.35:
                    _balcony(m, x0 + bw / 2, y0, 0.45 * bw, o.k + b)
        y0 += hs
        m.use("stone", o.k + s)
        if s < storeys - 1:
            m.box((width / 2, y0 - 0.1, 0.08), (width / 2, 0.1, 0.08), 4.0)
    # The cornice: three steps on brackets; the roof behind it.
    m.use("stone", o.k + 3)
    for j, (h, dep) in enumerate(((0.18, 0.15), (0.15, 0.3), (0.2, 0.45))):
        m.box((width / 2, y0 + 0.18 * j + h / 2, dep / 2), (width / 2, h / 2, dep / 2), 4.0)
    for x in np.arange(0.25, width - 0.1, 0.5):
        m.box((x, y0 - 0.12, 0.15), (0.05, 0.12, 0.15), 10.0)
    m.use("wall", wall)
    m.quad((0, y0 + 0.54, -ROOF_DEPTH), (0, 0, ROOF_DEPTH), (width, 0, 0), 0.0)


def _balcony(m: _Mesh, cx: float, y0: float, half: float, k: int) -> None:
    m.use("stone", k)
    m.box((cx, y0 + 0.06, 0.6), (half, 0.06, 0.6), 6.0)
    m.use("metal", k)
    m.box((cx, y0 + 1.05, 1.17), (half, 0.025, 0.025), 8.0)
    for side in (-1, 1):
        m.box((cx + side * half, y0 + 1.05, 0.6), (0.025, 0.025, 0.57), 8.0)
    for x in np.linspace(cx - half + 0.06, cx + half - 0.06, max(3, int(2 * half / 0.14))):
        m.cylinder((x, y0 + 0.12, 1.17), 0.012, 0.91, m.seg(6), 1, caps=False)


def _awning(m: _Mesh, o: Obj) -> None:
    """A shop's awning on the facade (its frame: x across, +z out of the wall)."""
    width, height = o.args
    m.use("stripes", o.k)
    m.sheet((-width / 2, height - 0.6, 1.6), (width, 0, 0), (0, 0.6, -1.6), 8.0, 0.01)
    m.sheet((-width / 2, height - 0.85, 1.6), (width, 0, 0), (0, 0.25, 0), 8.0, 0.01)
    m.use("metal", o.k)
    for side in (-1, 1):
        m.cylinder((side * width / 2, height - 0.6, 1.55), 0.015, 0.6, m.seg(6), 2, caps=False)


def _lantern(m: _Mesh, o: Obj) -> None:
    """A wall lantern (its frame: +z out of the wall)."""
    m.use("metal", o.k)
    m.box((0, 0, 0.2), (0.02, 0.02, 0.2), 10.0)
    m.cylinder((0, -0.3, 0.4), 0.1, 0.28, m.seg(12), m.seg(3, 1), top_radius=0.13)
    m.use("glass", o.k)
    m.sphere((0, -0.38, 0.4), 0.08, m.seg(14), m.seg(10))


def _street_lamp(m: _Mesh, o: Obj) -> None:
    m.use("metal", o.k)
    m.cylinder((0, 0, 0), 0.15, 0.5, m.seg(16), 2, top_radius=0.09)
    m.cylinder((0, 0.5, 0), 0.06, 3.6, m.seg(12), m.seg(16), top_radius=0.045)
    m.box((0.3, 3.95, 0), (0.35, 0.03, 0.03), 12.0)
    m.cylinder((0.6, 3.45, 0), 0.18, 0.42, m.seg(16), m.seg(4, 1), top_radius=0.24)
    m.cylinder((0.6, 3.87, 0), 0.26, 0.1, m.seg(16), 1, top_radius=0.02)
    m.use("glass", o.k)
    m.sphere((0.6, 3.38, 0), 0.16, m.seg(24), m.seg(16))


def _table(m: _Mesh, o: Obj) -> None:
    m.use("wood", o.k)
    m.cylinder((0, 0.72, 0), 0.35, 0.03, m.seg(32), 1)
    m.use("metal", o.k)
    m.cylinder((0, 0.03, 0), 0.03, 0.69, m.seg(12), m.seg(6, 1))
    m.cylinder((0, 0, 0), 0.22, 0.03, m.seg(24), 1)


def _chair(m: _Mesh, o: Obj) -> None:
    """A bistro chair, facing +z."""
    m.use("metal", o.k)
    for x, z in ((-0.19, -0.19), (0.19, -0.19), (-0.19, 0.19), (0.19, 0.19)):
        m.cylinder((x, 0, z), 0.014, 0.45, m.seg(8), m.seg(4, 1))
    for x in (-0.19, 0.19):
        m.cylinder((x, 0.47, -0.2), 0.014, 0.42, m.seg(8), m.seg(6, 1))
    m.use("weave", o.k)
    m.box((0, 0.46, 0), (0.22, 0.02, 0.22), 16.0)
    m.use("wood", o.k)
    for j in range(3):
        m.box((0, 0.6 + 0.1 * j, -0.2), (0.19, 0.03, 0.01), 20.0)


def _parasol(m: _Mesh, o: Obj) -> None:
    m.use("metal", o.k)
    m.box((0, 0.04, 0), (0.25, 0.04, 0.25), 8.0)
    m.cylinder((0, 0.08, 0), 0.025, 2.32, m.seg(10), m.seg(12))
    m.use("canvas", o.k)
    m.canopy((0, 2.45, 0), 1.1, 0.35, m.seg(32), m.seg(6))
    m.use("wood", o.k)
    m.sphere((0, 2.47, 0), 0.04, m.seg(8), m.seg(6))


def _planter(m: _Mesh, o: Obj) -> None:
    m.use("terracotta", o.k)
    m.box((0, 0.35, 0), (0.5, 0.35, 0.5), 6.0)
    m.use("foliage", o.k)
    m.sphere((0, 1.1, 0), 0.55, m.seg(48), m.seg(32), bumps=0.18, k=o.k)


def _bollard(m: _Mesh, o: Obj) -> None:
    m.use("metal", o.k)
    m.cylinder((0, 0, 0), 0.1, 0.85, m.seg(16), m.seg(6), caps=False)
    m.sphere((0, 0.85, 0), 0.1, m.seg(16), m.seg(8))


def _ground(m: _Mesh, o: Obj) -> None:
    """A stretch of the street from x0 to x1: the paving between the kerbs,
    the raised sidewalks before the facades and their kerbs."""
    x0, x1 = o.args
    inner = HALF_WIDTH - SIDEWALK
    run = (x1 - x0, 0, 0)
    m.use("ground", o.k)
    m.quad((x0, 0, -inner), (0, 0, 2 * inner), run, 2.0)
    m.use("ground", o.k + 1)
    m.quad((x0, KERB, -HALF_WIDTH), (0, 0, SIDEWALK), run, 2.0)
    m.quad((x0, KERB, inner), (0, 0, SIDEWALK), run, 2.0)
    m.use("stone", o.k)
    m.quad((x0, 0, -inner), run, (0, KERB, 0), 4.0)
    m.quad((x0, 0, inner), (0, KERB, 0), run, 4.0)


BUILDERS = dict(building=_building, awning=_awning, lantern=_lantern, street_lamp=_street_lamp,
                table=_table, chair=_chair, parasol=_parasol, planter=_planter, bollard=_bollard,
                ground=_ground)
PROPS = ("awning", "lantern", "street_lamp", "table", "chair", "parasol", "planter", "bollard")


# ---- the street --------------------------------------------------------------


def plan(seed: int = 1, length: float = 120.0) -> list[Obj]:
    """The street's objects, drawn from the seed: the ground in stretches of
    about 8 m, the buildings of each side with their awnings and lanterns,
    then the props."""
    rng = np.random.default_rng(int(seed) % 2**64)
    half = length / 2
    objs: list[Obj] = []

    def add(kind, x, y, z, angle=0.0, scale=1.0, args=()):
        objs.append(Obj(kind, float(x), float(y), float(z), float(angle), float(scale),
                        len(objs), tuple(args)))

    ends = np.linspace(-half - 4.0, half + 4.0, max(2, int(round((length + 8.0) / 8.0))) + 1)
    for x0, x1 in zip(ends[:-1], ends[1:]):
        add("ground", 0.0, 0.0, 0.0, args=(float(x0), float(x1)))

    for side in (-1, 1):  # facades at z = -20 facing +z, at z = +20 facing -z
        x = -half
        while x < half - 1e-6:
            width = float(min(half - x, rng.uniform(8.0, 14.0)))
            if half - x - width < 4.0:
                width = half - x
            storeys = int(rng.integers(2, 5))
            wall = int(rng.integers(0, 64))
            # The frame's origin goes to the facade's left end as seen from the street.
            ox, angle = (x, 0.0) if side < 0 else (x + width, math.pi)
            add("building", ox, 0.0, side * HALF_WIDTH, angle, 1.0, (width, storeys, wall))
            bays = max(2, int(round(width / 2.6)))
            bw = width / bays
            for b in range(bays):
                local = (b + 0.5) * bw
                wx = x + local if side < 0 else x + width - local
                if rng.uniform() < 0.55:
                    add("awning", wx, 0.0, side * HALF_WIDTH, angle, 1.0,
                        (0.62 * bw + 0.3, GROUND_STOREY - 0.15))
                elif rng.uniform() < 0.6:
                    lx = wx + 0.45 * bw * (1 if side < 0 else -1)
                    add("lantern", lx, 3.0, side * HALF_WIDTH, angle,
                        rng.uniform(0.9, 1.2))
            x += width
    # Cafe terraces in two bands beside the middle lane, each a table with
    # two to four chairs round it, and a parasol over two in five.
    for band in (-1, 1):
        for x in np.arange(-half + 1.6, half - 1.0, 2.6):
            for z in np.arange(5.9, 15.0, 2.0):
                cx = x + rng.uniform(-0.3, 0.3)
                cz = band * (z + rng.uniform(-0.25, 0.25))
                add("table", cx, 0.0, cz, rng.uniform(0, 2 * math.pi), rng.uniform(0.9, 1.1))
                chairs = int(rng.integers(2, 5))
                turn = rng.uniform(0, 2 * math.pi)
                for c in range(chairs):
                    a = turn + 2 * math.pi * c / chairs + rng.uniform(-0.3, 0.3)
                    r = rng.uniform(0.55, 0.7)
                    # A chair faces +z in its frame; turned to face the table.
                    add("chair", cx + r * math.cos(a), 0.0, cz + r * math.sin(a),
                        math.pi / 2 + a + rng.uniform(-0.4, 0.4), rng.uniform(0.92, 1.08))
                if rng.uniform() < 0.4:
                    add("parasol", cx, 0.0, cz, rng.uniform(0, 2 * math.pi),
                        rng.uniform(0.85, 1.15))
    # Planters along the middle lane; lamps and bollards along the kerbs.
    for band in (-1, 1):
        for x in np.arange(-half + 1.2, half - 0.5, 2.4):
            add("planter", x + rng.uniform(-0.2, 0.2), 0.0, band * 4.6,
                rng.uniform(0, 2 * math.pi), rng.uniform(0.8, 1.2))
        for x in np.arange(-half + 4.0, half - 1.0, 8.0):
            add("street_lamp", x, KERB, band * (HALF_WIDTH - SIDEWALK + 0.5),
                math.pi / 2 * (1 + band), rng.uniform(0.95, 1.05))
        for x in np.arange(-half + 2.0, half - 0.5, 2.0):
            if (x + half + 4.0) % 8.0 > 0.5:
                add("bollard", x, 0.0, band * (HALF_WIDTH - SIDEWALK - 0.3),
                    rng.uniform(0, 2 * math.pi), rng.uniform(0.9, 1.1))
    return objs


# Builders whose shape depends on the object's args alone (k picks only its
# maps): one mesh of each is made and placed as often as the plan asks.
SHARED = ("awning", "lantern", "street_lamp", "table", "chair", "parasol", "bollard")


def _build(objs, counting: bool, groups: dict, detail: float, seed: int):
    """Each object's mesh moved to its place, with its maps; counting, the
    triangles of each and the maps it uses."""
    out, made = [], {}
    for o in objs:
        key = (o.kind, o.args)
        if counting or key not in made:
            m = _Mesh(counting, groups, detail, seed)
            BUILDERS[o.kind](m, o)
            if counting:
                out.append((m.n, m.materials))
                continue
            mesh = (np.concatenate(m.pos), np.concatenate(m.uv),
                    [(n, g, k - o.k) for n, g, k in m.picks])
            if o.kind in SHARED:
                made[key] = mesh
        else:
            mesh = made[key]
        p, uv, picks = mesh
        mat = np.repeat([groups[g][0] + (o.k + dk) % groups[g][1] for _, g, dk in picks],
                        [n for n, _, _ in picks])
        c, s = math.cos(o.angle), math.sin(o.angle)
        # A turn about +y by angle: x' = c x + s z, z' = -s x + c z.
        x = c * p[..., 0] + s * p[..., 2]
        z = -s * p[..., 0] + c * p[..., 2]
        p = np.stack([x, p[..., 1], z], axis=-1) * o.scale + np.asarray([o.x, o.y, o.z])
        out.append((p, uv, mat))
    return out


def census(seed: int = 1, length: float = 120.0, detail: float = 1.0, textures: int = 56,
           texture_size: int = 1024) -> dict:
    """What `make` with these arguments gives, counted without making it:
    triangles, objects (the props apart), each prop's triangles, the maps and
    their bytes, and how many objects use each map."""
    objs = plan(seed, length)
    built = _build(objs, True, _groups(textures), detail, seed)
    props = [(o.kind, n) for o, (n, _) in zip(objs, built) if o.kind in PROPS]
    users = [0] * textures
    for _, mats in built:
        for mat in mats:
            users[mat] += 1
    return dict(triangles=int(sum(n for n, _ in built)), objects=len(objs), props=len(props),
                prop_triangles=[n for _, n in props],
                by_kind={k: sum(1 for kind, _ in props if kind == k) for k in PROPS},
                map_users=users, texture_size=texture_size,
                texel_bytes=4 * textures * texture_size**2)


def make(seed: int = 1, length: float = 120.0, detail: float = 1.0, textures: int = 56,
         texture_size: int = 1024) -> Scene:
    """The street (module docstring)."""
    objs = plan(seed, length)
    groups = _groups(textures)
    parts = _build(objs, False, groups, detail, seed)
    positions = np.concatenate([p for p, _, _ in parts]).astype(np.float32)
    uvs = np.concatenate([t for _, t, _ in parts]).astype(np.float32)
    materials = np.concatenate([mat for _, _, mat in parts]).astype(np.uint32)
    e1 = positions[:, 1] - positions[:, 0]
    e2 = positions[:, 2] - positions[:, 0]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    normals = np.repeat(n[:, None, :], 3, axis=1).astype(np.float32)
    return Scene(positions, normals, uvs, materials,
                 street_textures(textures, texture_size, groups, seed))


# ---- the maps ----------------------------------------------------------------


def _noise(size: int, cells: int, rng) -> np.ndarray:
    """Tileable value noise in [0, 1]: a random coarse grid, bilinear."""
    coarse = rng.uniform(size=(cells, cells)).astype(np.float32)
    x = np.arange(size, dtype=np.float32) * (cells / size)
    i = x.astype(np.int64)
    f = (x - i).astype(np.float32)
    j = (i + 1) % cells
    rows = coarse[i] * (1 - f)[:, None] + coarse[j] * f[:, None]  # (size, cells)
    return rows[:, i] * (1 - f)[None, :] + rows[:, j] * f[None, :]


def _pattern(group: str, k: int, size: int, rng) -> np.ndarray:
    """One map of the group, (size, size, 3) float RGB in [0, 1]."""
    tint = rng.uniform(0.75, 1.0, 3).astype(np.float32)
    yy = np.arange(size, dtype=np.float32)[:, None] / size
    xx = np.arange(size, dtype=np.float32)[None, :] / size
    grain = 0.85 + 0.3 * _noise(size, 32, rng)
    if group in ("ground", "weave"):
        cells = 24 if group == "ground" else 48
        a = ((np.floor(yy * cells) + np.floor(xx * cells)) % 2).astype(np.float32)
        base = 0.45 + 0.2 * a[..., None] * tint
    elif group == "wall":
        rows = np.floor(yy * 16)
        xoff = (xx + 0.5 * (rows % 2) / 8) % 1.0
        mortar = ((yy * 16) % 1.0 < 0.08) | ((xoff * 8) % 1.0 < 0.04)
        brick = k % 2 == 0
        base = np.where(mortar[..., None] & brick, 0.8, 0.62 + 0.2 * tint).astype(np.float32)
    elif group == "glass":
        base = (0.15 + 0.25 * yy[..., None] + 0 * xx[..., None]) * np.asarray([0.7, 0.8, 1.0])
    elif group in ("stone", "terracotta"):
        band = 0.5 + 0.5 * np.sin(2 * np.pi * (5 * yy + 1.5 * _noise(size, 4, rng)))
        base = (0.6 + 0.25 * band[..., None]) * tint
        if group == "terracotta":
            base = base * np.asarray([0.95, 0.55, 0.35])
    elif group == "metal":
        base = 0.25 + 0.1 * tint + 0 * xx[..., None]
    elif group == "wood":
        g = 0.5 + 0.5 * np.sin(2 * np.pi * (12 * xx + 2.0 * _noise(size, 6, rng)))
        base = (0.45 + 0.2 * g[..., None]) * np.asarray([0.8, 0.55, 0.35]) * tint
    elif group == "stripes":
        s = (np.floor(xx * (8 + 2 * (k % 3))) % 2 + 0 * yy)[..., None]
        base = np.where(s > 0, 0.9, 0.35 + 0.5 * tint * np.asarray([1.0, 0.3, 0.3]))
    elif group == "canvas":
        base = (0.7 + 0.25 * tint) * np.ones((size, size, 1), np.float32)
    else:  # foliage
        base = (0.25 + 0.35 * _noise(size, 96, rng)[..., None]) * np.asarray([0.45, 0.8, 0.3])
    return np.clip(np.broadcast_to(base, (size, size, 3)) * grain[..., None], 0.0, 1.0)


def _bgra(rgb: np.ndarray) -> Texture:
    """(h, w, 3) float RGB -> 8-bit -> BGRA words with alpha 255."""
    u8 = np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint32)
    bgra = u8[..., 2] | (u8[..., 1] << 8) | (u8[..., 0] << 16) | np.uint32(255 << 24)
    return Texture(bgra.reshape(-1).astype(np.uint32), rgb.shape[1], rgb.shape[0])


def street_textures(textures: int, size: int, groups: dict | None = None,
                    seed: int = 1) -> list[Texture]:
    """The street's maps, in group order (GROUPS)."""
    groups = _groups(textures) if groups is None else groups
    out = [None] * textures
    for g, (first, count) in groups.items():
        for k in range(count):
            rng = np.random.default_rng([int(seed) % 2**64, first + k])
            out[first + k] = _bgra(_pattern(g, k, size, rng))
    return out

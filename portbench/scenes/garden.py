"""A garden courtyard at production scale: the benchmark's stand-in for a
vegetation-heavy set like San Miguel's hacienda courtyard, whose files are
not in the repository.

An enclosed courtyard, `width` x `depth` metres, paved, under the sky: on
its four sides two-storey arcades (columns, arches, a gallery with its
balustrade) before the buildings' facades (scenes/street.py `_building`);
in it a fountain, trees, potted plants along the arcades, planted boxes and
cafe tables with chairs and parasols (street.py's). A tree is a trunk,
branches and twigs, and its leaves are opaque two-triangle cards clustered
on the twigs; a potted plant's leaves are cards on its stems. Most of the
triangles are leaf cards (`census` gives the share). `foliage` scales the
number of cards, each card's edge by 1/sqrt(foliage), so that a canopy of
fewer cards covers as much. The base colours are `textures` maps of
`texture_size` squared RGBA8 texels, each shared by several objects: the
street's sets (scenes/street.py `_pattern`) and sets of leaves and bark.

`make(seed, width, depth, detail, foliage, textures, texture_size)` returns
the flat triangle soup and the textures as plain numpy arrays, as the other
generators do. The same arguments give the same scene, bit for bit.
`plan(...)` lists the objects and `census(...)` counts their triangles
without making any, by the same code (the builders run in a counting mode).
"""

from __future__ import annotations

import math

import numpy as np

from . import street
from .courtyard import Scene
from .street import Obj, _Mesh

ARCADE = 3.6  # from the colonnade back to the facades
BAY = 3.2  # the colonnade's column spacing
GROUND_STOREY = 4.2
UPPER_STOREY = 3.5

GROUPS = ("ground", "wall", "glass", "stone", "metal", "wood", "weave", "canvas", "terracotta",
          "foliage", "leaf", "bark")
_SHARES = (8, 6, 4, 10, 4, 6, 4, 3, 8, 3, 56, 16)  # of 128

# Cards per tree at foliage 1: branches x twigs per branch x cards per twig.
TREE_BRANCHES = 48
TREE_TWIGS = 50
TREE_CARDS = 176
# A potted plant at foliage 1: stems x cards per stem; variants of its mesh.
PLANT_STEMS = 16
PLANT_CARDS = 550
PLANT_VARIANTS = 6
# A leaf card's half extents (metres) at foliage 1.
TREE_CARD = (0.06, 0.045)
PLANT_CARD = (0.08, 0.05)


def _groups(textures: int) -> dict:
    """{group: (first map, number of maps)}: the maps split by _SHARES."""
    counts = [max(1, round(s * textures / sum(_SHARES))) for s in _SHARES]
    counts[GROUPS.index("leaf")] += textures - sum(counts)
    if min(counts) < 1:
        raise ValueError(f"{textures} maps cannot hold the {len(GROUPS)} groups")
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return {g: (int(f), int(n)) for g, f, n in zip(GROUPS, first, counts)}


def _cards(foliage: float, count: int) -> int:
    return max(1, int(round(count * foliage)))


# ---- batched primitives ------------------------------------------------------


def _frames(axis: np.ndarray):
    """Two unit vectors across each unit `axis` (n, 3), and the axis."""
    ref = np.where(np.abs(axis[:, 1:2]) < 0.9, [[0.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]])
    e1 = np.cross(axis, ref)
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    return e1, np.cross(axis, e1)


def _limbs(m: _Mesh, p0, p1, r0, r1, seg: int) -> None:
    """n tapered open tubes from p0 to p1 (n, 3), radii r0 to r1 (n,), of
    `seg` sides and one ring each; each side faces outward."""
    n = len(p0)
    m._emit(2 * seg * n)
    if m.counting:
        return
    axis = p1 - p0
    length = np.linalg.norm(axis, axis=1, keepdims=True)
    e1, e2 = _frames(axis / length)
    ang = 2.0 * math.pi * np.arange(seg + 1) / seg
    ring = np.cos(ang)[None, :, None] * e1[:, None] + np.sin(ang)[None, :, None] * e2[:, None]
    lo = p0[:, None] + np.asarray(r0).reshape(-1, 1, 1) * ring  # (n, seg + 1, 3)
    hi = p1[:, None] + np.asarray(r1).reshape(-1, 1, 1) * ring
    a, b, c, d = lo[:, :-1], lo[:, 1:], hi[:, 1:], hi[:, :-1]
    # (a, c, b) and (a, d, c) face outward for a ring turning from e1 to e2.
    m.pos.append(np.concatenate([np.stack([a, c, b], 2), np.stack([a, d, c], 2)], 1)
                 .reshape(-1, 3, 3))
    s = np.linspace(0.0, 1.0, seg + 1)
    ua, ub = s[:-1], s[1:]
    tex = np.stack([np.stack([ua, 0 * ua], -1), np.stack([ub, 1 + 0 * ub], -1),
                    np.stack([ub, 0 * ub], -1)], 1)
    tex2 = np.stack([np.stack([ua, 0 * ua], -1), np.stack([ua, 1 + 0 * ua], -1),
                     np.stack([ub, 1 + 0 * ub], -1)], 1)
    uv = np.concatenate([tex, tex2], 0)[None] * np.stack(
        [np.ones(n), length[:, 0]], -1)[:, None, None, :]
    m.uv.append(uv.reshape(-1, 3, 2))


def _leaf_cards(m: _Mesh, centers, normals, along, half) -> None:
    """n opaque leaf cards: rectangles at `centers` facing `normals`, their
    long side across `along` (each (n, 3)), of half extents `half` (n, 2);
    two triangles each, the whole map across the card."""
    n = len(centers)
    m._emit(2 * n)
    if m.counting:
        return
    nrm = normals / np.linalg.norm(normals, axis=1, keepdims=True)
    a = np.cross(nrm, along)
    a /= np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
    b = np.cross(nrm, a)  # a x b = nrm
    a, b = a * half[:, :1], b * half[:, 1:]
    p00, p10, p11, p01 = centers - a - b, centers + a - b, centers + a + b, centers - a + b
    m.pos.append(np.concatenate([np.stack([p00, p10, p11], 1), np.stack([p00, p11, p01], 1)]))
    uv = np.asarray([[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]], np.float64)
    m.uv.append(np.repeat(uv, n, axis=0))


def _unit(rng, n: int) -> np.ndarray:
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


# ---- the objects -------------------------------------------------------------


def _tree(m: _Mesh, o: Obj) -> None:
    """A tree at its frame's origin: a trunk clear to `clear` metres, then
    `branches` branches of `twigs` twigs each, every twig holding `cards`
    leaf cards clustered round it, in a crown of radius `crown`."""
    crown, clear, branches, twigs, cards, scale = o.args
    m.use("bark", o.k)
    m.cylinder((0, 0, 0), 0.28, clear + 1.4 * crown, m.seg(16), m.seg(8), caps=False,
               top_radius=0.1)
    nt = branches * twigs
    per_branch = twigs * cards
    if m.counting:
        m.use("bark", o.k + 1)
        m._emit(2 * m.seg(8) * branches)
        m.use("bark", o.k + 2)
        m._emit(2 * 3 * nt)
        for b in range(branches):
            m.use("leaf", o.k + b)
            m._emit(2 * per_branch)
        return
    rng = np.random.default_rng([m.seed, o.k, 11])
    # Branches from the upper trunk, out and up.
    az = 2.0 * math.pi * (np.arange(branches) + rng.uniform(0, 1, branches)) / branches
    el = np.radians(rng.uniform(12.0, 62.0, branches))
    bdir = np.stack([np.cos(el) * np.cos(az), np.sin(el), np.cos(el) * np.sin(az)], -1)
    b0 = np.stack([0 * az, rng.uniform(clear, clear + 0.9 * crown, branches), 0 * az], -1)
    blen = crown * rng.uniform(0.75, 1.05, branches)[:, None]
    m.use("bark", o.k + 1)
    _limbs(m, b0, b0 + blen * bdir, np.full(branches, 0.09), np.full(branches, 0.025),
           m.seg(8))
    # Twigs along each branch, turned off it.
    t = rng.uniform(0.3, 1.0, nt)
    bi = np.repeat(np.arange(branches), twigs)
    t0 = b0[bi] + (t[:, None] * blen[bi]) * bdir[bi]
    tdir = bdir[bi] + 0.9 * _unit(rng, nt)
    tdir /= np.linalg.norm(tdir, axis=1, keepdims=True)
    tlen = rng.uniform(0.45, 0.85, nt)[:, None]
    m.use("bark", o.k + 2)
    _limbs(m, t0, t0 + tlen * tdir, np.full(nt, 0.012), np.full(nt, 0.004), 3)
    # The cards of each twig, each branch's on a map of its own.
    nc = nt * cards
    ti = np.repeat(np.arange(nt), cards)
    s = rng.uniform(0.0, 1.0, nc)[:, None]
    centers = t0[ti] + s * tlen[ti] * tdir[ti] + 0.07 * rng.normal(size=(nc, 3))
    normals = _unit(rng, nc) + [0.0, 0.7, 0.0]
    half = np.asarray(TREE_CARD) * scale * rng.uniform(0.8, 1.2, (nc, 1))
    for b in range(branches):
        rows = slice(b * per_branch, (b + 1) * per_branch)
        m.use("leaf", o.k + b)
        _leaf_cards(m, centers[rows], normals[rows], tdir[ti[rows]], half[rows])


def _potted_plant(m: _Mesh, o: Obj) -> None:
    """A terracotta pot with `stems` stems arching out of it, each with
    `cards` leaf cards along it (variant `args[0]` draws the shape)."""
    variant, stems, cards, scale = o.args
    m.use("terracotta", o.k)
    m.cylinder((0, 0, 0), 0.3, 0.55, m.seg(24), m.seg(3, 1), top_radius=0.38)
    m.use("ground", o.k)
    m.cylinder((0, 0.5, 0), 0.36, 0.01, m.seg(24), 1, caps=False)
    nc = stems * cards
    if m.counting:
        m.use("bark", o.k)
        m._emit(2 * 4 * stems)
        for j in range(2):
            m.use("leaf", o.k + j)
            m._emit(2 * ((j + 1) * nc // 2 - j * nc // 2))
        return
    rng = np.random.default_rng([m.seed, variant, 13])
    az = 2.0 * math.pi * (np.arange(stems) + rng.uniform(0, 1, stems)) / stems
    el = np.radians(rng.uniform(35.0, 80.0, stems))
    sdir = np.stack([np.cos(el) * np.cos(az), np.sin(el), np.cos(el) * np.sin(az)], -1)
    s0 = np.stack([0.12 * np.cos(az), np.full(stems, 0.5), 0.12 * np.sin(az)], -1)
    slen = rng.uniform(0.7, 1.3, stems)[:, None]
    m.use("bark", o.k)
    _limbs(m, s0, s0 + slen * sdir, np.full(stems, 0.012), np.full(stems, 0.005), 4)
    si = np.repeat(np.arange(stems), cards)
    s = rng.uniform(0.15, 1.0, nc)[:, None]
    centers = s0[si] + s * slen[si] * sdir[si] + 0.08 * rng.normal(size=(nc, 3))
    normals = _unit(rng, nc) + [0.0, 0.9, 0.0]
    half = np.asarray(PLANT_CARD) * scale * rng.uniform(0.7, 1.3, (nc, 1))
    for j in range(2):
        rows = slice(j * nc // 2, (j + 1) * nc // 2)
        m.use("leaf", o.k + j)
        _leaf_cards(m, centers[rows], normals[rows], sdir[si[rows]], half[rows])


def _arcade(m: _Mesh, o: Obj) -> None:
    """A two-storey arcade in its frame: the facade's line z = 0 (the
    building behind it), the colonnade at z = ARCADE, `bays` bays of BAY
    from x = 0; the ground storey's columns carry round arches, the
    gallery's a balustrade and the roof."""
    bays, first = o.args
    length = bays * BAY
    z = ARCADE
    y1 = GROUND_STOREY
    y2 = y1 + UPPER_STOREY
    for b in range(bays + 1):
        x = b * BAY
        m.use("stone", first + b)
        m.box((x, 0.15, z), (0.3, 0.15, 0.3), 4.0)
        m.cylinder((x, 0.3, z), 0.2, y1 - 1.9, m.seg(16), m.seg(4, 1), caps=False,
                   top_radius=0.18)
        m.box((x, y1 - 1.52, z), (0.27, 0.08, 0.27), 4.0)
        m.use("stone", first + b + 1)
        m.cylinder((x, y1 + 0.95, z), 0.14, y2 - y1 - 1.05, m.seg(12), m.seg(3, 1),
                   caps=False, top_radius=0.13)
    # The arches: voussoirs round each bay's half circle.
    m.use("stone", first)
    r = BAY / 2 - 0.2
    spring = y1 - 1.45
    for b in range(bays):
        cx = b * BAY + BAY / 2
        for j in range(m.seg(12, 6)):
            a = math.pi * (j + 0.5) / m.seg(12, 6)
            m.box((cx - r * math.cos(a), spring + r * math.sin(a), z),
                  (0.13, 0.13, 0.28), 2.0)
    m.use("wall", first)
    # The spandrel wall over the arches, the gallery's floor and the roof.
    m.quad((0, spring + r + 0.1, z + 0.3), (length, 0, 0), (0, y1 - spring - r - 0.1, 0), 2.0)
    m.box((length / 2, y1 + 0.12, z / 2), (length / 2, 0.12, z / 2 + 0.35), 1.5)
    m.box((length / 2, y2 + 0.1, z / 2), (length / 2, 0.1, z / 2 + 0.6), 1.0)
    # The gallery's balustrade: a rail on turned balusters.
    m.use("stone", first + 2)
    m.box((length / 2, y1 + 0.95, z), (length / 2, 0.06, 0.16), 3.0)
    for x in np.arange(0.25, length - 0.1, 0.22):
        m.cylinder((x, y1 + 0.24, z), 0.045, 0.65, m.seg(6), m.seg(3, 1), caps=False,
                   top_radius=0.03)


def _fountain(m: _Mesh, o: Obj) -> None:
    m.use("stone", o.k)
    m.cylinder((0, 0, 0), 2.4, 0.6, m.seg(64), m.seg(3, 1))
    m.cylinder((0, 0.6, 0), 0.35, 1.1, m.seg(24), m.seg(6, 1), caps=False, top_radius=0.22)
    m.cylinder((0, 1.7, 0), 0.9, 0.25, m.seg(48), 2, top_radius=1.1)
    m.sphere((0, 2.15, 0), 0.22, m.seg(16), m.seg(10))


def _paving(m: _Mesh, o: Obj) -> None:
    """A strip of paving from x0 to x1 across z0 .. z1."""
    x0, x1, z0, z1 = o.args
    m.use("ground", o.k)
    m.quad((x0, 0, z0), (0, 0, z1 - z0), (x1 - x0, 0, 0), 2.0)


BUILDERS = dict(building=street._building, arcade=_arcade, tree=_tree,
                potted_plant=_potted_plant, planter=street._planter, table=street._table,
                chair=street._chair, parasol=street._parasol, fountain=_fountain,
                paving=_paving)
# Builders whose shape depends on the object's args alone (k picks only its
# maps): one mesh of each is made and placed as often as the plan asks.
SHARED = ("potted_plant", "table", "chair", "parasol")
FOLIAGE = ("tree", "potted_plant")


# ---- the courtyard -----------------------------------------------------------


def plan(seed: int = 1, width: float = 44.0, depth: float = 32.0,
         foliage: float = 1.0) -> list[Obj]:
    """The courtyard's objects, drawn from the seed: the paving, the arcades
    and the buildings of its four sides, the fountain, the trees, the potted
    plants, the planted boxes, the cafe tables."""
    rng = np.random.default_rng(int(seed) % 2**64)
    hx, hz = width / 2, depth / 2
    objs: list[Obj] = []
    scale = 1.0 / math.sqrt(foliage)

    def add(kind, x, y, z, angle=0.0, size=1.0, args=()):
        objs.append(Obj(kind, float(x), float(y), float(z), float(angle), float(size),
                        len(objs), tuple(args)))

    edges = np.linspace(-hx - ARCADE, hx + ARCADE, max(2, int(round(width / 8.0))) + 1)
    for x0, x1 in zip(edges[:-1], edges[1:]):
        add("paving", 0.0, 0.0, 0.0, args=(float(x0), float(x1), -hz - ARCADE, hz + ARCADE))

    # Each side: its colonnade along the courtyard's edge, the facades
    # ARCADE behind it; a frame's +z faces into the courtyard.
    sides = (  # (origin of the side's run, angle, run length)
        ((-hx, -hz - ARCADE), 0.0, width),
        ((hx, hz + ARCADE), math.pi, width),
        ((hx + ARCADE, -hz), -math.pi / 2, depth),
        ((-hx - ARCADE, hz), math.pi / 2, depth),
    )
    for (ox, oz), angle, run in sides:
        c, s = math.cos(angle), math.sin(angle)
        bays = max(1, int(round(run / BAY)))
        add("arcade", ox, 0.0, oz, angle, run / (bays * BAY), (bays, int(rng.integers(0, 64))))
        along = 0.0
        while along < run - 1e-6:
            w = float(min(run - along, rng.uniform(8.0, 14.0)))
            if run - along - w < 4.0:
                w = run - along
            add("building", ox + c * along, 0.0, oz - s * along, angle, 1.0,
                (w, 2, int(rng.integers(0, 64))))
            along += w
        # Potted plants along the colonnade, between its columns.
        for j in range(bays):
            a = (j + 0.5) * BAY * run / (bays * BAY)
            px, pz = ox + c * a + s * (ARCADE + 0.9), oz - s * a + c * (ARCADE + 0.9)
            add("potted_plant", px, 0.0, pz, rng.uniform(0, 2 * math.pi),
                rng.uniform(0.85, 1.15),
                (int(rng.integers(0, PLANT_VARIANTS)), PLANT_STEMS,
                 _cards(foliage, PLANT_CARDS), scale))

    add("fountain", 0.0, 0.0, 0.0)
    # Trees on a jittered grid, clear of the fountain.
    for tx in np.linspace(-hx + 0.18 * width, hx - 0.18 * width, 4):
        for tz in np.linspace(-hz + 0.22 * depth, hz - 0.22 * depth, 3):
            if abs(tx) < 0.2 * width and abs(tz) < 0.2 * depth:
                continue
            add("tree", tx + rng.uniform(-1.0, 1.0), 0.0, tz + rng.uniform(-1.0, 1.0),
                rng.uniform(0, 2 * math.pi), rng.uniform(0.9, 1.1),
                (float(rng.uniform(4.0, 5.0)), float(rng.uniform(2.6, 3.2)), TREE_BRANCHES,
                 TREE_TWIGS, _cards(foliage, TREE_CARDS), scale))
    # Planted boxes and potted plants round the fountain.
    for j in range(9):
        a = 2 * math.pi * (j + 0.5) / 9
        add("planter", 3.8 * math.cos(a), 0.0, 3.8 * math.sin(a), a, rng.uniform(0.9, 1.1))
        add("potted_plant", 5.2 * math.cos(a + 0.4), 0.0, 5.2 * math.sin(a + 0.4),
            rng.uniform(0, 2 * math.pi), rng.uniform(0.85, 1.15),
            (int(rng.integers(0, PLANT_VARIANTS)), PLANT_STEMS,
             _cards(foliage, PLANT_CARDS), scale))
    # Cafe tables by the arcades, each with two to four chairs and a parasol.
    for band in (-1, 1):
        for x in np.arange(-hx + 3.0, hx - 2.0, 3.4):
            cx = x + rng.uniform(-0.3, 0.3)
            cz = band * (hz - 2.6 + rng.uniform(-0.3, 0.3))
            add("table", cx, 0.0, cz, rng.uniform(0, 2 * math.pi), rng.uniform(0.9, 1.1))
            chairs = int(rng.integers(2, 5))
            turn = rng.uniform(0, 2 * math.pi)
            for c in range(chairs):
                a = turn + 2 * math.pi * c / chairs + rng.uniform(-0.3, 0.3)
                r = rng.uniform(0.55, 0.7)
                add("chair", cx + r * math.cos(a), 0.0, cz + r * math.sin(a),
                    math.pi / 2 + a + rng.uniform(-0.4, 0.4), rng.uniform(0.92, 1.08))
            add("parasol", cx, 0.0, cz, rng.uniform(0, 2 * math.pi), rng.uniform(0.85, 1.15))
    return objs


def _build(objs, counting: bool, groups: dict, detail: float, seed: int):
    """Each object's mesh moved to its place, with its maps; counting, the
    triangles of each, its leaf-card triangles and the maps it uses."""
    out, made = [], {}
    for o in objs:
        key = (o.kind, o.args)
        if counting or key not in made:
            m = _Mesh(counting, groups, detail, seed)
            BUILDERS[o.kind](m, o)
            if counting:
                leaves = sum(n for n, g, _ in m.picks if g == "leaf")
                out.append((m.n, leaves, m.materials))
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
        out.append((p.astype(np.float32), uv.astype(np.float32), mat))
    return out


def census(seed: int = 1, width: float = 44.0, depth: float = 32.0, detail: float = 1.0,
           foliage: float = 1.0, textures: int = 128, texture_size: int = 2048) -> dict:
    """What `make` with these arguments gives, counted without making it:
    triangles, those of leaf cards and their share, objects, trees and
    potted plants, the maps and their bytes, and how many objects use each
    map."""
    objs = plan(seed, width, depth, foliage)
    built = _build(objs, True, _groups(textures), detail, seed)
    users = [0] * textures
    for _, _, mats in built:
        for mat in mats:
            users[mat] += 1
    triangles = int(sum(n for n, _, _ in built))
    leaves = int(sum(n for _, n, _ in built))
    return dict(triangles=triangles, leaf_triangles=leaves, foliage_share=leaves / triangles,
                objects=len(objs), by_kind={k: sum(1 for o in objs if o.kind == k)
                                            for k in BUILDERS},
                map_users=users, texture_size=texture_size,
                texel_bytes=4 * textures * texture_size**2)


def make(seed: int = 1, width: float = 44.0, depth: float = 32.0, detail: float = 1.0,
         foliage: float = 1.0, textures: int = 128, texture_size: int = 2048) -> Scene:
    """The courtyard (module docstring)."""
    objs = plan(seed, width, depth, foliage)
    groups = _groups(textures)
    parts = _build(objs, False, groups, detail, seed)
    positions = np.concatenate([p for p, _, _ in parts])
    uvs = np.concatenate([t for _, t, _ in parts])
    materials = np.concatenate([mat for _, _, mat in parts]).astype(np.uint32)
    del parts
    e1 = positions[:, 1] - positions[:, 0]
    e2 = positions[:, 2] - positions[:, 0]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    normals = np.repeat(n[:, None, :], 3, axis=1)
    return Scene(positions, normals, uvs, materials,
                 garden_textures(textures, texture_size, groups, seed))


# ---- the maps ----------------------------------------------------------------


def _pattern(group: str, k: int, size: int, rng) -> np.ndarray:
    """One map of the group, (size, size, 3) float RGB in [0, 1]: leaves and
    bark here, the street's sets from street.py."""
    if group not in ("leaf", "bark"):
        return street._pattern(group, k, size, rng)
    yy = np.arange(size, dtype=np.float32)[:, None] / size
    xx = np.arange(size, dtype=np.float32)[None, :] / size
    if group == "leaf":
        # Leaves of one hue per map, yellow-green to dark green, with veins.
        hue = rng.uniform(0.0, 1.0)
        tint = np.asarray([0.25 + 0.35 * hue, 0.45 + 0.25 * hue, 0.12 + 0.1 * hue], np.float32)
        blotch = street._noise(size, 48, rng)
        vein = np.abs(np.sin(np.float32(2 * np.pi * 10) * (xx + 0.3 * yy + 0.05 * blotch)))
        shade = 0.55 + 0.35 * blotch + 0.15 * (vein > 0.95)
        return np.clip(shade[..., None] * tint, 0.0, 1.0)
    furrow = 0.5 + 0.5 * np.sin(2 * np.pi * (24 * xx + 3.0 * street._noise(size, 8, rng)))
    grain = 0.8 + 0.3 * street._noise(size, 64, rng)
    tint = rng.uniform(0.85, 1.0, 3).astype(np.float32) * np.asarray([0.42, 0.34, 0.27])
    return np.clip(((0.6 + 0.4 * furrow) * grain)[..., None] * tint, 0.0, 1.0)


def garden_textures(textures: int, size: int, groups: dict | None = None,
                    seed: int = 1) -> list:
    """The courtyard's maps, in group order (GROUPS)."""
    groups = _groups(textures) if groups is None else groups
    out = [None] * textures
    for g, (first, count) in groups.items():
        for k in range(count):
            rng = np.random.default_rng([int(seed) % 2**64, first + k])
            out[first + k] = street._bgra(_pattern(g, k, size, rng))
    return out

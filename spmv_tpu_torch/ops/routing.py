"""3-stage tile routing: plan-time decomposition of arbitrary
within-(128,128)-tile gathers into three lane gathers and two
transposes.

Counterpart of `spmv_tpu/ops/routing.py`, copied so the port plans the
same route stages. Any gather ``out[r2,c2] = in[r1,c1]`` within a tile
factors as::

    out = lane_gather(T(lane_gather(T(lane_gather(in, s1)), s2)), s3)

by assigning each required (r1 -> r2) flow an intermediate lane
("color") such that per source row each color carries one source
column, and per destination row each color is used once. With both
deduped side degrees <= 128 this is a 128-edge-coloring of a bipartite
multigraph (Konig), constructed by recursive Euler splitting. The
CUDA kernels read the three uint8 stages as is (kernels/tile_ops.py
states the composed form they evaluate).

The hot implementation is native (spmv_tpu_torch/native/host.cpp,
spmv_route_tiles); this module holds the ctypes-free mirror used for
tests and as a fallback.
"""

from __future__ import annotations

import numpy as np

LANES = 128
TILE = LANES * LANES


def route_tiles(src: np.ndarray, dedupe: bool = True,
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Plan 3-stage routes for T tiles.

    src: (T, 128, 128) int32; src[t, r2, c2] = flat in-tile source
    position r1*128+c1, or -1 for don't-care slots (output there is
    unspecified; callers mask). Returns (s1, s2, s3), each
    (T, 128, 128) uint8.

    dedupe=False asserts the map is injective per tile (each live
    output slot reads a distinct source slot, e.g. shuffle split
    perms) — the native path then skips its 8 MB dedup stamp table,
    whose random misses dominate per-tile planning cost.

    Raises ValueError if a tile's deduped flow degree exceeds 128
    (cannot happen for bijections-with-don't-cares; pathological
    duplicating gathers must be split by the caller).
    """
    src = np.ascontiguousarray(src, dtype=np.int32)
    assert src.ndim == 3 and src.shape[1:] == (LANES, LANES)
    T = src.shape[0]
    try:
        from spmv_tpu_torch import native

        if native.available():
            return native.route_tiles(src, dedupe=dedupe)
    except NotImplementedError:
        pass
    return route_tiles_py(src)


def _euler_color_py(eu: np.ndarray, ev: np.ndarray) -> np.ndarray:
    """128-edge-coloring of a 128-regular bipartite multigraph with
    E=16384 edges via recursive Euler splitting. Pure Python mirror of
    euler_color_128 in host.cpp."""
    E = eu.shape[0]
    assert E == TILE
    group = np.zeros(E, dtype=np.int64)
    for level in range(7):
        ngroups = 1 << level
        order = np.argsort(group, kind="stable")
        bounds = np.searchsorted(group[order], np.arange(ngroups + 1))
        for g in range(ngroups):
            edges = order[bounds[g]:bounds[g + 1]]
            if edges.size == 0:
                continue
            # adjacency: vertices 0..127 left, 128..255 right
            adj = [[] for _ in range(256)]
            for e in edges:
                adj[eu[e]].append(e)
                adj[128 + ev[e]].append(e)
            it = [0] * 256
            visited = {}
            for e0 in edges:
                if e0 in visited:
                    continue
                cur = int(eu[e0])
                side = 0
                while True:
                    e = -1
                    while it[cur] < len(adj[cur]):
                        cand = adj[cur][it[cur]]
                        it[cur] += 1
                        if cand not in visited:
                            e = cand
                            break
                    if e < 0:
                        break
                    visited[e] = True
                    group[e] = 2 * g + side
                    side ^= 1
                    cur = 128 + int(ev[e]) if cur < 128 else int(eu[e])
    return group


def route_tiles_py(src: np.ndarray):
    """Pure-Python route planner (slow; tests and fallback)."""
    T = src.shape[0]
    s1 = np.zeros((T, LANES, LANES), dtype=np.uint8)
    s2 = np.zeros((T, LANES, LANES), dtype=np.uint8)
    s3 = np.zeros((T, LANES, LANES), dtype=np.uint8)
    for t in range(T):
        S = src[t].reshape(-1)
        # dedupe edges by (r1, c1, r2)
        keymap: dict = {}
        eu, ev, ec1 = [], [], []
        slot_edge = np.full(TILE, -1, dtype=np.int64)
        degl = np.zeros(LANES, np.int64)
        degr = np.zeros(LANES, np.int64)
        for i in range(TILE):
            sp = int(S[i])
            if sp < 0:
                continue
            if sp >= TILE:
                raise ValueError("route: src out of range")
            r2 = i >> 7
            r1, c1 = sp >> 7, sp & 127
            key = (sp << 7) | r2
            e = keymap.get(key)
            if e is None:
                if degl[r1] >= LANES or degr[r2] >= LANES:
                    raise ValueError(
                        "route: tile degree exceeds 128; split the gather")
                e = len(eu)
                keymap[key] = e
                eu.append(r1)
                ev.append(r2)
                ec1.append(c1)
                degl[r1] += 1
                degr[r2] += 1
            slot_edge[i] = e
        # pad to 128-regular
        li = ri = 0
        while len(eu) < TILE:
            while degl[li] >= LANES:
                li += 1
            while degr[ri] >= LANES:
                ri += 1
            eu.append(li)
            ev.append(ri)
            ec1.append(0)
            degl[li] += 1
            degr[ri] += 1
        eu_a = np.asarray(eu, np.int64)
        ev_a = np.asarray(ev, np.int64)
        color = _euler_color_py(eu_a, ev_a)
        ec1_a = np.asarray(ec1, np.int64)
        s1[t, eu_a, color] = ec1_a
        s2[t, color, ev_a] = eu_a
        live = slot_edge >= 0
        s3[t].reshape(-1)[live] = color[slot_edge[live]]
    return s1, s2, s3


def apply_routes_np(tiles: np.ndarray, s1, s2, s3) -> np.ndarray:
    """NumPy reference of the kernel-side route application."""
    a = np.take_along_axis(tiles, s1.astype(np.int64), axis=2)
    a = a.transpose(0, 2, 1)
    a = np.take_along_axis(a, s2.astype(np.int64), axis=2)
    a = a.transpose(0, 2, 1)
    return np.take_along_axis(a, s3.astype(np.int64), axis=2)

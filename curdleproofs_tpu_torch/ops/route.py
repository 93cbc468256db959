"""3-stage permutation routing for the routed gather (host side).

Counterpart of the JAX package's `ops.route`. Viewing n positions as an
(r x c) matrix (n = r*c), Hall's theorem factors ANY permutation as

    within-rows  o  within-columns  o  within-rows

turning one permutation gather into three row-local gathers with table widths
c, r, c (`ops.gather.routed_gather` is the device half). The JAX package
routes because a gather on its machine is a one-hot matrix product whose cost
is quadratic in the table width; a GPU thread loads from the address, so here
the routed gather is one of two ways to the same records and the direct
gather (`ops.gather.gather_u32`) is the other.

The routing is computed here on the host: the bipartite multigraph with one
edge (source row -> dest row) per element is c-regular, hence (Koenig)
c-edge-colorable; color(e) = the column the element travels through. Colors
come from recursive Euler splitting — walk Euler circuits of each subgraph
assigning alternate edges to the two halves (circuits are even, the graph
being bipartite), halving the degree per level: O(n log c).

Native implementation in ../csrc/route.c (utils.host_native); the pure-Python
twin below is its oracle and what runs where the machine has no C compiler.
The two need not pick the same colouring: both route the permutation. The
JAX package's `decompose_packed` (its transfer wire format) has no
counterpart: index tables go to the card as they are.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from curdleproofs_tpu_torch.utils import host_native


def native_available() -> bool:
    return host_native.available()


def pick_rc(n: int, min_factor: int = 128) -> Tuple[int, int]:
    """Factor n = r*c minimizing 2c + r (the summed table widths of the three
    stages), with both factors >= min_factor. Requires a power-of-two
    n >= min_factor^2. The JAX package's choice, so both route at equal
    (r, c)."""
    if n & (n - 1) or n < min_factor * min_factor:
        raise ValueError("routed gather needs power-of-two n >= min_factor^2")
    best = None
    c = min_factor
    while c * min_factor <= n:
        r = n // c
        if r >= min_factor:
            cost = 2 * c + r
            if best is None or cost < best[0]:
                best = (cost, r, c)
        c *= 2
    assert best is not None
    return best[1], best[2]


def decompose(r: int, c: int, src: np.ndarray):
    """Route W permutations of n = r*c elements.

    src: (W, n) int32, src[w, d] = source position of the element that must
    end at position d.  Returns (idx1 (W, r, c), idx2 (W, c, r),
    idx3 (W, r, c)) int32 with, writing in_w for the source vector:

        s1[w, a, j]  = in_w[a*c + idx1[w, a, j]]     (gather within src rows)
        s2[w, j, a2] = s1[w, idx2[w, j, a2], j]      (gather within columns)
        s3[w, a2, b] = s2[w, idx3[w, a2, b], a2]     (gather within dst rows)

    so that s3[w, a2, b] = in_w[src[w, a2*c + b]]. The native solver packs a
    row pair into 32 bits, so r <= 65,535."""
    if r > 65535:
        raise ValueError("route.decompose: r must be at most 65535")
    if host_native.available():
        return host_native.route_decompose(r, c, src)
    return decompose_py(r, c, src)


def decompose_py(r: int, c: int, src: np.ndarray):
    """Pure-Python twin of the native solver (tests / no C compiler)."""
    n = r * c
    src = np.ascontiguousarray(src, dtype=np.int32).reshape(-1, n)
    W = src.shape[0]
    idx1 = np.empty((W, r, c), np.int32)
    idx2 = np.empty((W, c, r), np.int32)
    idx3 = np.empty((W, r, c), np.int32)
    for w in range(W):
        color = _color_edges_py(r, c, src[w])
        d = np.arange(n)
        row_s, col_s = src[w] // c, src[w] % c
        row_d, col_d = d // c, d % c
        idx1[w, row_s, color] = col_s
        idx2[w, color, row_d] = row_s
        idx3[w, row_d, col_d] = color
    return idx1, idx2, idx3


def _color_edges_py(r: int, c: int, src: np.ndarray) -> np.ndarray:
    """Euler-split edge coloring; color[d] in [0, c), distinct within every
    source row and every dest row."""
    n = r * c
    row_s = src // c
    color = np.zeros(n, np.int32)
    stack = [(np.arange(n, dtype=np.int32), c, 0)]
    while stack:
        grp, k, base = stack.pop()
        if k == 1:
            color[grp] = base
            continue
        bits = _euler_halve_py(r, c, row_s, grp)
        stack.append((grp[bits == 0], k // 2, base))
        stack.append((grp[bits == 1], k // 2, base + k // 2))
    return color


def _euler_halve_py(r, c, row_s, grp):
    m = len(grp)
    head = {}
    nxt = np.empty(2 * m, np.int64)
    eid = np.empty(2 * m, np.int64)
    for i in range(m):
        e = int(grp[i])
        u = int(row_s[e])
        v = r + e // c
        nxt[2 * i] = head.get(u, -1)
        head[u] = 2 * i
        eid[2 * i] = i
        nxt[2 * i + 1] = head.get(v, -1)
        head[v] = 2 * i + 1
        eid[2 * i + 1] = i
    used = np.zeros(m, bool)
    bits = np.zeros(m, np.uint8)
    for i0 in range(m):
        if used[i0]:
            continue
        node = int(row_s[grp[i0]])
        parity = 0
        while True:
            h = head.get(node, -1)
            while h != -1 and used[eid[h]]:
                h = nxt[h]
            head[node] = h
            if h == -1:
                break
            i = int(eid[h])
            used[i] = True
            bits[i] = parity
            parity ^= 1
            e = int(grp[i])
            u = int(row_s[e])
            v = r + e // c
            node = v if node == u else u
    return bits

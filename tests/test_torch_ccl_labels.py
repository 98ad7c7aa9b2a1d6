"""The labels kernel's route, checks and algorithm on the CPU.

``connected_component_labels_batched`` launches a min-root union-find on the
card (``csrc/ccl.cu`` ``k2_ccl_labels``): a tile pass in shared memory, a
face pass and a compress pass. The kernel cannot run here, so its algorithm
is emulated below in numpy, one tile and one voxel pair at a time as the
threads do, with the threads' memory steps interleaved in a seeded random
order (each interleaving is one order the atomics may take on the card), and
held exactly against impact_tpu's labels on grids whose tiles do not divide
G. The CPU route itself (the plain fixpoint sweep) is held against
impact_tpu at G = 39 and 40, the sizes the shared-memory sweep kernel no
longer takes. Bars: labels exactly equal; integer minima have no rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impact_tpu.voxel.interaction import connected_component_labels as jax_labels
from impact_tpu_torch.ops import ccl_pallas as k2
from impact_tpu_torch.voxel.interaction import connected_component_labels


def serpentine(g):
    occ = np.zeros((g, g, g), bool)
    occ[0::2, :, 0] = True
    for i in range(1, g, 2):
        occ[i, g - 1 if (i // 2) % 2 == 0 else 0, 0] = True
    return occ


def edge_grids(g, seed):
    """Random fills, the serpentine, full, checkerboard (every voxel its own
    component) and one voxel at each corner."""
    rng = np.random.default_rng(seed)
    grids = [rng.uniform(size=(g, g, g)) < f for f in (0.3, 0.6)]
    i, j, k = np.indices((g, g, g))
    corners = np.zeros((g, g, g), bool)
    corners[::g - 1, ::g - 1, ::g - 1] = True
    return grids + [serpentine(g), np.ones((g, g, g), bool), (i + j + k) % 2 == 0, corners]


# --- a sequential emulation of the three passes --------------------------------


def _find(par, x):
    """Root of x with intermediate pointer jumping (each node walked is
    re-pointed to its grandparent); a generator that yields after each read
    and write."""
    cur = par[x]
    yield
    if cur == x:
        return x
    prev = x
    while True:
        nxt = par[cur]
        yield
        if not cur > nxt:
            return cur
        par[prev] = nxt
        yield
        prev, cur = cur, nxt


def _run(thread):
    """Run one generator thread alone to its end; its return value."""
    try:
        while True:
            next(thread)
    except StopIteration as stop:
        return stop.value


def _union(par, a, b):
    """The kernel's union: hook the larger root under the smaller with a
    compare-and-swap; a failed hook (the root was hooked meanwhile) goes on
    from the root's new parent."""
    a = yield from _find(par, a)
    b = yield from _find(par, b)
    while a != b:
        if a > b:
            a, b = b, a
        old = par[b]
        if old == b:  # atomicCAS(par + b, b, a)
            par[b] = a
        yield
        if old == b:
            return
        b = old


def _compress(lab, v):
    """The compress pass's thread: v's root, walked without stores, written
    to v's own cell."""
    p = r = lab[v]
    yield
    if p < 0:
        return
    while True:
        nxt = lab[r]
        yield
        if not r > nxt:
            break
        r = nxt
    if r != p:
        lab[v] = r
        yield


def _interleave(threads, rng):
    """Run generator threads to their end, one step of a random thread at a
    time."""
    live = list(threads)
    while live:
        i = int(rng.integers(len(live)))
        try:
            next(live[i])
        except StopIteration:
            live[i] = live[-1]
            live.pop()


def _thread(steps):
    for a, b in steps:
        yield from a(*b)


def emulate_labels(occ, tile, rng):
    """Labels of one bool grid [G,G,G] by the kernel's three passes on tiles
    of shape ``tile`` (i, j, k)."""
    g = occ.shape[0]
    lab = np.full(g ** 3, -1, np.int64)
    nt = [-(-g // t) for t in tile]
    tiles = [(ti, tj, tk) for ti in range(nt[0]) for tj in range(nt[1]) for tk in range(nt[2])]
    local = np.indices(tile).reshape(3, -1).T  # l -> (ii, jj, kk)
    for t0 in tiles:  # tile pass: the blocks do not share memory
        o = np.array(t0) * tile
        ijk = o + local
        inside = (ijk < g).all(axis=1)
        occupied = np.zeros(len(local), bool)
        occupied[inside] = occ[tuple(ijk[inside].T)]
        # each voxel starts under the first voxel of its run along k
        start = np.zeros(len(local), np.int64)
        for lidx in range(len(local)):
            kk = local[lidx][2]
            start[lidx] = start[lidx - 1] if kk > 0 and occupied[lidx - 1] else kk
        par = np.where(occupied, np.arange(len(local)) - local[:, 2] + start, -1)
        threads = []
        for lidx in np.flatnonzero(occupied):
            left = local[lidx][2] > start[lidx]
            steps = []
            for axis, s in ((1, tile[2]), (0, tile[1] * tile[2])):
                if (local[lidx][axis] > 0 and occupied[lidx - s]
                        and not (left and occupied[lidx - s - 1])):
                    steps.append((_union, (par, lidx, lidx - s)))
            threads.append(_thread(steps))
        _interleave(threads, rng)
        for lidx in np.flatnonzero(occupied):
            r = _run(_find(par, lidx))
            i, j, k = ijk[lidx]
            ri, rj, rk = ijk[r]
            lab[(i * g + j) * g + k] = (ri * g + rj) * g + rk
    threads = []  # face pass: every tile's three low faces at once
    for t0 in tiles:
        o = np.array(t0) * tile
        for axis, step, along in ((0, g * g, 1), (1, g, 1), (2, 1, g)):
            if o[axis] == 0:
                continue
            others = [a for a in range(3) if a != axis]
            for u in range(tile[others[0]]):
                for w in range(tile[others[1]]):
                    ijk = o.copy()
                    ijk[others[0]] += u
                    ijk[others[1]] += w
                    if (ijk >= g).any():
                        continue
                    v = (ijk[0] * g + ijk[1]) * g + ijk[2]
                    if not (occ.flat[v] and occ.flat[v - step]):
                        continue
                    if w > 0 and occ.flat[v - along] and occ.flat[v - along - step]:
                        continue  # joined through the pair one step along the face
                    threads.append(_union(lab, v, v - step))
    _interleave(threads, rng)
    _interleave([_compress(lab, v) for v in range(g ** 3)], rng)  # compress pass
    return lab.reshape(g, g, g)


@pytest.mark.parametrize("tile", [(4, 4, 4), (8, 8, 8), (2, 4, 16)])
@pytest.mark.parametrize("g", [13, 21])
def test_emulated_union_find_matches_reference(g, tile):
    rng = np.random.default_rng(g * 100 + sum(tile))
    for occ in edge_grids(g, g):
        ref = np.asarray(jax_labels(jnp.asarray(occ)))
        np.testing.assert_array_equal(emulate_labels(occ, tile, rng), ref)


# --- the CPU route, the checks and the bounds ----------------------------------


@pytest.mark.parametrize("g", [39, 40])
def test_cpu_labels_match_reference(g):
    rng = np.random.default_rng(g)
    grids = [rng.uniform(size=(g, g, g)) < 0.3, serpentine(g)]
    got = connected_component_labels(torch.from_numpy(np.stack(grids)))
    assert got.dtype == torch.int32
    for occ, lab in zip(grids, got):
        np.testing.assert_array_equal(lab.numpy(), np.asarray(jax_labels(jnp.asarray(occ))))


@pytest.mark.parametrize("g,n_bytes,fits", [(38, 226348, True), (39, 244692, False),
                                            (40, 264000, False)])
def test_shared_memory_fit(g, n_bytes, fits):
    """The shared-memory sweep kernel asks for 4·G³ + 4·⌈G³/32⌉ bytes; a
    block may opt into 232,448 on the H100, so G = 39 and 40 take K2-wide."""
    assert k2.k2_shared_bytes(g) == n_bytes
    assert k2.k2_fits_shared(g) is fits


def test_labels_wrapper_checks_inputs():
    occ = torch.zeros((2, 8, 8, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="bool"):
        k2.connected_component_labels_batched(occ.to(torch.uint8))
    with pytest.raises(ValueError, match=r"\[B,G,G,G\]"):
        k2.connected_component_labels_batched(occ[0])
    with pytest.raises(ValueError, match=r"\[B,G,G,G\]"):
        k2.connected_component_labels_batched(occ[..., :7])
    with pytest.raises(ValueError, match="contiguous"):
        k2.connected_component_labels_batched(occ.permute(0, 3, 2, 1))
    with pytest.raises(ValueError, match="cuda or cpu"):
        k2.connected_component_labels_batched(occ.to("meta"))
    huge = torch.empty((1, 1291, 1291, 1291), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="i32"):
        k2.connected_component_labels_batched(huge)
    empty = k2.connected_component_labels_batched(occ[:0])
    assert empty.shape == (0, 8, 8, 8) and empty.dtype == torch.int32


@pytest.mark.parametrize("shape,n_bytes", [((4, 32, 32, 32), 655360),
                                           ((4, 63, 63, 63), 5000940)])
def test_labels_bound(shape, n_bytes):
    """1 B of occupancy in and 4 B of label out per voxel over 3.35 TB/s; the
    three face tests per voxel at 67 T/s take less."""
    ms, by = k2.labels_bound_ms(torch.zeros(shape, dtype=torch.bool))
    assert by == "bytes"
    assert ms == pytest.approx(n_bytes / 3.35e12 * 1e3, rel=1e-12)

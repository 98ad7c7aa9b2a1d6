"""The process-group plumbing of the sharded code: every collective that the
parallel modules issue goes through a :class:`Comm` (the port's own; the
reference lets XLA insert its collectives).

A Comm holds the process group of each mesh axis and issues ``all_gather``,
``broadcast``, ``all_reduce`` and the halo's pair of point-to-point
transfers on them. Each call is recorded (op, axis, shape, dtype, bytes;
a packed gather also records the shape of each tensor in it), so tests can
pin the collective pattern as the reference's tests read it from the HLO.

Transport. :func:`resolve_backend` picks it, and nothing falls back:

* ``cuda`` tensors ride ``nccl`` when each rank has a card of its own.
  When the ranks outnumber the cards, NCCL cannot serve them (it refuses
  two ranks on one card), so the caller must ask for ``gloo``; otherwise
  it raises.
* With ``gloo`` and ``cuda`` tensors, every collective is staged through
  host memory explicitly: the tensor is copied to the host, the collective
  runs there, the result is copied back. ``staged_bytes`` counts both
  copies. Such ranks say nothing about a multi-card speed.
* ``cpu`` tensors ride ``gloo``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


def resolve_backend(device, backend: str | None, n_ranks: int) -> str:
    """The transport of ``n_ranks`` ranks whose tensors live on ``device``:
    ``nccl`` on the card when each rank has a card of its own, ``gloo`` on
    the CPU or when the caller asks for it. Raises ValueError when the
    ranks outnumber the cards and ``gloo`` was not asked for, or when a
    backend cannot carry the device's tensors."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"cpu tensors ride gloo, not {backend!r}")
        return "gloo"
    if dev.type != "cuda":
        raise ValueError(f"no transport for {dev.type} tensors")
    if backend == "gloo":
        return "gloo"
    if backend not in (None, "nccl"):
        raise ValueError(f"cuda tensors ride nccl or host-staged gloo, not {backend!r}")
    n_cards = torch.cuda.device_count()
    if n_ranks > n_cards:
        raise ValueError(f"{n_ranks} ranks but {n_cards} card(s): NCCL needs a card per rank; "
                         "pass backend='gloo' to stage the collectives through host memory")
    return "nccl"


class CollectiveRecord(NamedTuple):
    op: str  # all_gather, broadcast, all_reduce, halo
    axis: str
    shape: tuple  # of the result (a gather's whole output)
    dtype: str
    bytes: int  # of the result
    parts: tuple  # ((shape, dtype), ...) of the tensors packed into it


def _pack(tensors, n_rows: int):
    """Tensors with a leading dim of ``n_rows`` → one u8 [n_rows, K] (each
    row's bytes side by side) and what unpacks it."""
    cols, meta = [], []
    for t in tensors:
        t = t.contiguous()
        flat = t.reshape(n_rows, -1)
        cols.append(flat.view(torch.uint8) if flat.numel() else
                    torch.zeros((n_rows, 0), dtype=torch.uint8, device=t.device))
        meta.append((t.shape[1:], t.dtype, cols[-1].shape[1]))
    return torch.cat(cols, dim=1), meta


def _unpack(packed, meta):
    out, at = [], 0
    for shape, dtype, width in meta:
        # a fresh flat copy: a view as a wider dtype needs aligned storage
        col = packed[:, at:at + width].reshape(-1).clone()
        at += width
        out.append(col.view(dtype).reshape(packed.shape[0], *shape))
    return out


class Comm:
    """The collectives of one rank of a mesh. ``groups``: mesh axis name →
    (process group, this rank's coordinate, axis size)."""

    def __init__(self, groups: dict, device, backend: str):
        self.groups = groups
        self.device = torch.device(device)
        self.backend = backend
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.records: list[CollectiveRecord] = []
        self.staged_bytes = 0

    def size(self, axis: str) -> int:
        return self.groups[axis][2]

    def coordinate(self, axis: str) -> int:
        return self.groups[axis][1]

    def _global(self, axis: str, index: int) -> int:
        return dist.get_global_rank(self.groups[axis][0], index)

    def _record(self, op, axis, t, parts=None):
        self.records.append(CollectiveRecord(
            op, axis, tuple(t.shape), str(t.dtype).removeprefix("torch."),
            t.numel() * t.element_size(),
            tuple(parts) if parts is not None else ((tuple(t.shape), str(t.dtype)),)))

    def _wire(self, t):
        """The tensor the transport reads: a host copy when staging."""
        t = t.contiguous()
        if self.staged:
            self.staged_bytes += t.numel() * t.element_size()
            return t.cpu()
        return t

    def _back(self, t):
        if self.staged:
            self.staged_bytes += t.numel() * t.element_size()
            return t.to(self.device)
        return t

    def clear(self):
        self.records.clear()
        self.staged_bytes = 0

    # --- collectives -----------------------------------------------------------
    def all_gather(self, t, axis: str = "objects", parts=None):
        """The axis's blocks of ``t`` concatenated along dim 0, in
        coordinate order (on every rank of the axis)."""
        group, _, n = self.groups[axis]
        w = self._wire(t)
        out = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(out, w, group=group)
        res = self._back(torch.cat(out))
        self._record("all_gather", axis, res, parts)
        return res

    def all_gather_rows(self, tensors, axis: str = "objects"):
        """Each tensor's blocks (leading dims equal) gathered along dim 0, all
        in one collective: the rows' bytes are packed side by side."""
        n_rows = tensors[0].shape[0]
        packed, meta = _pack(tensors, n_rows)
        n = self.size(axis)
        parts = [((n * n_rows,) + tuple(t.shape[1:]), str(t.dtype)) for t in tensors]
        return _unpack(self.all_gather(packed, axis, parts), meta)

    def broadcast(self, t, src: int, axis: str = "objects"):
        """``t`` of the rank at coordinate ``src`` of the axis, on every rank
        of it (the others pass a tensor of the same shape and dtype)."""
        w = self._wire(t).clone()
        dist.broadcast(w, src=self._global(axis, src), group=self.groups[axis][0])
        res = self._back(w)
        self._record("broadcast", axis, res)
        return res

    def broadcast_rows(self, tensors, src: int, axis: str = "objects"):
        """Several tensors of the rank at ``src`` (leading dims equal) in one
        broadcast."""
        n_rows = tensors[0].shape[0]
        packed, meta = _pack(tensors, n_rows)
        w = self._wire(packed).clone()
        dist.broadcast(w, src=self._global(axis, src), group=self.groups[axis][0])
        res = self._back(w)
        self._record("broadcast", axis, res,
                     [(tuple(t.shape), str(t.dtype)) for t in tensors])
        return _unpack(res, meta)

    def all_reduce(self, t, axis: str = "objects", op: str = "sum"):
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
        w = self._wire(t).clone()
        dist.all_reduce(w, op=ops[op], group=self.groups[axis][0])
        res = self._back(w)
        self._record("all_reduce", axis, res)
        return res

    def halo(self, send_left, send_right, axis: str = "space"):
        """The halo pair along a ring-less axis: each rank sends its first
        planes to its left neighbour and its last to its right one, and
        receives (from_left, from_right); an edge receives None on its open
        side and sends nothing past it. A direction whose send is None (on
        every rank of the axis) moves nothing: a None ``send_left`` leaves
        ``from_right`` None, a None ``send_right`` ``from_left``."""
        group, me, n = self.groups[axis]
        wl = self._wire(send_left) if send_left is not None else None
        wr = self._wire(send_right) if send_right is not None else None
        from_left = torch.empty_like(wr) if me > 0 and wr is not None else None
        from_right = torch.empty_like(wl) if me < n - 1 and wl is not None else None
        ops = []
        if me > 0:
            peer = self._global(axis, me - 1)
            if wl is not None:
                ops.append(dist.P2POp(dist.isend, wl, peer, group))
            if from_left is not None:
                ops.append(dist.P2POp(dist.irecv, from_left, peer, group))
        if me < n - 1:
            peer = self._global(axis, me + 1)
            if wr is not None:
                ops.append(dist.P2POp(dist.isend, wr, peer, group))
            if from_right is not None:
                ops.append(dist.P2POp(dist.irecv, from_right, peer, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        got = [self._back(x) if x is not None else None for x in (from_left, from_right)]
        for x in got:
            if x is not None:
                self._record("halo", axis, x)
        return got[0], got[1]

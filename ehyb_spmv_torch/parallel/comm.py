"""The sharded path's exchanges over ``torch.distributed``.

Port counterpart of the collectives of
``ehyb_spmv_gpu_tpu/parallel/spmv.py::_shard_body``: the ring halos
(``ppermute``, ``:606-609``) and the compressed ``all_to_all`` of the ER
and long-row columns (``:619-622``), and of ``process_allgather`` in
``recover_y`` (``:932-938``).

Each rank keeps one persistent buffer ``x_buf = [left halo W | local R |
right halo W | recv D*S]``.  The local rows are written into its middle
(``x_local``), the halos are received in place from the ring neighbours
(the edge ranks keep zeros), and the values each owner sends at the
conversion's request (``send_idx``) land in ``recv``, where the remapped ER
and long columns point.  So the body, the ER and long rows and DIA all read
one vector, and nothing is concatenated per apply.

A world of one rank runs no collective.  Gloo takes CPU tensors; for a
rank on a card it runs over host copies: :class:`ShardExchange` then
stages what it sends and receives through pinned host buffers, a step it
logs when it is set up and names in ``staged``.  NCCL takes the card's
tensors as they are (one card per rank).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.log import get_logger

log = get_logger(__name__)


def group_rank_world(group=None) -> Tuple[object, int, int]:
    """(group, rank, world size): of ``group``, of the default group where
    one is initialized, else a world of one rank with no group."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return None, 0, 1
    return group, dist.get_rank(group), dist.get_world_size(group)


def rank_device(device, rank: int) -> torch.device:
    """The device of a rank: ``device`` as given, or where it is None or
    "cuda", ``cuda:{rank % device_count}`` (every rank on the one card of
    a one-card machine); raises where a card is asked for and CUDA is not
    available."""
    if device is None or str(device) == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a rank on the card was asked for and CUDA "
                               "is not available (pass device='cpu' to run "
                               "on the CPU)")
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device)


def stages(group, device: torch.device) -> bool:
    """Whether this group needs host copies of ``device``'s tensors."""
    return (group is not None and device.type == "cuda"
            and dist.get_backend(group) == "gloo")


class ShardExchange:
    """One rank's ``x_buf`` and the exchanges that fill its halos and
    ``recv``: :meth:`start` posts them, :meth:`finish` waits for them."""

    def __init__(self, group, rank: int, world: int, R: int, W: int,
                 send_idx: np.ndarray, S: int, device, dtype="float32"):
        self.group, self.rank, self.world = group, rank, world
        self.R, self.W, self.S = R, W, S
        self.device = torch.device(device)
        tdt = getattr(torch, str(np.dtype(dtype)))
        n = R + 2 * W + world * S
        #: [left halo W | local R | right halo W | recv D*S], zeros at first
        #: (an edge rank's missing halo stays zero).
        self.x_buf = torch.zeros(n, dtype=tdt, device=self.device)
        self.x_local = self.x_buf[W:W + R]
        self.left = self.x_buf[:W]
        self.right = self.x_buf[W + R:R + 2 * W]
        self.recv = self.x_buf[R + 2 * W:]
        #: Whether the ER exchange runs (more than one rank and S > 0).
        self.exchanges = world > 1 and S > 0
        self.send_idx = torch.as_tensor(
            np.ascontiguousarray(send_idx, dtype=np.int64).reshape(-1)
            [: world * S], device=self.device)
        #: Whether the exchanges run over pinned host copies (gloo with a
        #: rank on a card).
        self.staged = world > 1 and stages(group, self.device)
        if self.staged:
            # one send and one receive buffer: [first W | last W | payload]
            # and [left halo | right halo | recv]
            n_io = 2 * W + world * S
            self.h_send = torch.empty(n_io, dtype=tdt, pin_memory=True)
            self.h_recv = torch.zeros(n_io, dtype=tdt, pin_memory=True)
            self.d_send = torch.empty(n_io, dtype=tdt, device=self.device)
            log.info("rank %d: %s backend with %s tensors — the exchanges "
                     "are staged through pinned host buffers (%d values "
                     "each way an apply)", rank, dist.get_backend(group),
                     self.device, n_io)

    # -- the exchanges -----------------------------------------------------
    def _post(self, first, last, payload, left, right, recv) -> List:
        """Post the halo sends/receives and the ER all-to-all on the given
        tensors; returns their work handles."""
        works = []
        g, r = self.group, self.rank
        peer = lambda q: dist.get_global_rank(g, q)  # noqa: E731
        if r + 1 < self.world:   # my last W rows are my right neighbour's
            works.append(dist.isend(last, peer(r + 1), group=g))
            works.append(dist.irecv(right, peer(r + 1), group=g))
        if r > 0:                # my first W rows are my left neighbour's
            works.append(dist.isend(first, peer(r - 1), group=g))
            works.append(dist.irecv(left, peer(r - 1), group=g))
        if self.exchanges:
            works.append(dist.all_to_all_single(recv, payload, group=g,
                                                async_op=True))
        return works

    def start(self) -> Optional[List]:
        """Post this apply's exchanges (none in a world of one rank)."""
        if self.world == 1:
            return None
        R, W = self.R, self.W
        xl = self.x_local
        if not self.staged:
            payload = (xl.index_select(0, self.send_idx) if self.exchanges
                       else None)
            return self._post(xl[:W], xl[R - W:], payload, self.left,
                              self.right, self.recv)
        # staged: gather what leaves this rank on the card, copy it to the
        # host in one piece (the copy waits for the card), post on the host
        d = self.d_send
        d[:W].copy_(xl[:W])
        d[W:2 * W].copy_(xl[R - W:])
        if self.exchanges:
            torch.index_select(xl, 0, self.send_idx, out=d[2 * W:])
        self.h_send.copy_(d)
        h, o = self.h_send, self.h_recv
        return self._post(h[:W], h[W:2 * W], h[2 * W:], o[:W], o[W:2 * W],
                          o[2 * W:])

    def finish(self, works: Optional[List]) -> None:
        """Wait for the exchanges of :meth:`start`; staged, copy what
        arrived into ``x_buf`` (in the card's stream order)."""
        if works is None:
            return
        for w in works:
            w.wait()
        if self.staged:
            W, o = self.W, self.h_recv
            if self.rank > 0:
                self.left.copy_(o[:W], non_blocking=True)
            if self.rank + 1 < self.world:
                self.right.copy_(o[W:2 * W], non_blocking=True)
            if self.exchanges:
                self.recv.copy_(o[2 * W:], non_blocking=True)


def all_gather_rows(group, world: int, y: torch.Tensor) -> torch.Tensor:
    """Every rank's ``y`` (equal lengths), concatenated in rank order, on
    ``y``'s device; ``y`` itself in a world of one rank.  Gloo with a card
    gathers host copies (one copy each way)."""
    if world == 1:
        return y
    y = y.contiguous()
    if stages(group, y.device):
        src = y.cpu()
        out = src.new_empty(world * src.shape[0])
        dist.all_gather_into_tensor(out, src, group=group)
        return out.to(y.device)
    out = y.new_empty(world * y.shape[0])
    dist.all_gather_into_tensor(out, y, group=group)
    return out

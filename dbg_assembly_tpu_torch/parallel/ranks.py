"""Shard slots over processes: the mesh's collectives over torch.distributed.

Counterpart of the multi-process side of the JAX package
(tools/launch_distributed.py: one process a host under jax.distributed,
every device of every process on one global 'd' axis).  A ``RankMesh`` is
D = world x local shard slots; rank r holds the contiguous slots
[r * local, (r + 1) * local), all on its one device:
  * nccl: the card whose index is the rank's place among its host's ranks
    (rank r on one host); more ranks on a host than it has cards raises,
    since NCCL refuses two ranks on one card;
  * gloo with cuda: the same place mod the card count, so several ranks
    may share a card; every collective's tensors go through host memory,
    copied there and back explicitly;
  * gloo with cpu: the CPU.
It has ``mesh.Mesh``'s interface (``n``, ``devices`` (this rank's slots),
``first_slot``, ``all_to_all``, ``sum_ints``), so parallel/count_sharded's
steps run on it unchanged.  The APIs used are ``all_to_all_single`` and
``all_reduce``.

``bytes_across`` counts the bytes this process sends other processes; the
moves between its own slots count in ``mesh.bytes_moved``, as in one
process.
"""

from __future__ import annotations

import socket
from datetime import timedelta

import torch
import torch.distributed as dist

from .. import resolve_device
from . import mesh as meshmod

# bytes this process sent other processes through the collectives since
# import (or since the caller last reset it)
bytes_across = 0


class RankMesh:
    """This rank's ``local`` slots of a mesh of world x local slots."""

    def __init__(self, local: int, rank: int, world: int,
                 device: torch.device, backend: str):
        if local < 1:
            raise ValueError(f"a rank needs local >= 1 slots, not {local}")
        self.local, self.rank, self.world = local, rank, world
        self.n = world * local
        self.first_slot = rank * local
        self.devices = [device] * local
        self.backend = backend
        # where the collectives' tensors live: NCCL moves device memory,
        # gloo here host memory
        self.comm = device if backend == "nccl" else torch.device("cpu")
        self.staged = self.comm != device

    def layout(self) -> str:
        """E.g. "2 of 4 slots (rank 1 of 2) on cuda:0, gloo, device tensors
        staged through host memory"."""
        route = ", device tensors staged through host memory" \
            if self.staged else ""
        return (f"{self.local} of {self.n} slots (rank {self.rank} of "
                f"{self.world}) on {self.devices[0]}, {self.backend}{route}")

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.comm) if self.staged else t

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.devices[0]) if self.staged else t

    def sum_ints(self, *values: int) -> list[int]:
        """Each value summed over every rank (all_reduce)."""
        t = torch.tensor(values, dtype=torch.int64, device=self.comm)
        dist.all_reduce(t)
        return t.tolist()

    def max_int(self, value: int) -> int:
        """The largest of every rank's value (all_reduce)."""
        t = torch.tensor([value], dtype=torch.int64, device=self.comm)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return int(t.item())

    def all_to_all(self, bufs: list[list[torch.Tensor]]):
        """bufs[s][t] is what local slot s sends global slot t (sizes may
        differ, one dtype).  Returns recv with recv[t] = the concatenation
        over every global source slot, in global order, of what it sends
        local slot t, on its device: mesh.all_to_all over processes.

        The split sizes cross first (all_to_all_single of a [world, local,
        local] block), then the data in one all_to_all_single; what stays
        in this rank moves between its slots without a collective."""
        global bytes_across
        L, W, r = self.local, self.world, self.rank
        dev = self.devices[0]

        def own(t):
            return [meshmod._move(bufs[s][r * L + t], dev, s != t)
                    for s in range(L)]

        if W == 1:
            return [torch.cat(own(t)) for t in range(L)]
        # sizes[q, s, t]: what local slot s sends slot t of rank q
        sizes = torch.tensor([[b.shape[0] for b in row] for row in bufs],
                             dtype=torch.int64).view(L, W, L).transpose(0, 1)
        sizes[r] = 0
        got = torch.empty(W * L * L, dtype=torch.int64, device=self.comm)
        dist.all_to_all_single(got, sizes.reshape(-1).to(self.comm))
        got = got.view(W, L, L).cpu()          # got[p, s, t] from rank p
        send = torch.cat([bufs[s][q * L + t] for q in range(W) if q != r
                          for s in range(L) for t in range(L)])
        in_split = sizes.sum(dim=(1, 2)).tolist()
        out_split = got.sum(dim=(1, 2)).tolist()
        recv = torch.empty(sum(out_split), dtype=send.dtype,
                           device=self.comm)
        dist.all_to_all_single(recv, self._out(send), out_split, in_split)
        bytes_across += send.numel() * send.element_size()
        pieces = self._in(recv).split(got.reshape(-1).tolist())
        out = []
        for t in range(L):
            parts = []
            for p in range(W):
                parts += own(t) if p == r else \
                    [pieces[(p * L + s) * L + t] for s in range(L)]
            out.append(torch.cat(parts))
        return out


def init(coordinator: str, world: int, rank: int, local: int,
         backend: str = "nccl", device="cuda",
         timeout: float = 600.0) -> RankMesh:
    """Join the process group at ``coordinator`` (host:port, rank 0 listens
    there) and return this rank's slots.  Every wait is bounded by
    ``timeout`` seconds.  device "cuda" without a card raises; nccl needs
    device "cuda" and at most one rank a card on each host."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, not {backend!r}")
    kind = resolve_device(device).type
    if backend == "nccl" and kind != "cuda":
        raise ValueError("the nccl backend moves CUDA tensors only; run "
                         "--device cpu with --backend gloo")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside 0..{world - 1}")
    host, port = coordinator.rsplit(":", 1)
    wait = timedelta(seconds=timeout)
    store = dist.TCPStore(host, int(port), world, rank == 0, timeout=wait)
    # every rank's host and card count: a rank's card is its place among
    # its host's ranks, and every rank sees every host's crowding
    me = socket.gethostname()
    cards = torch.cuda.device_count() if kind == "cuda" else 0
    store.set(f"host/{rank}", f"{cards} {me}")
    seen = [store.get(f"host/{q}").decode().split(" ", 1)
            for q in range(world)]
    hosts = [h for _, h in seen]
    crowded = sorted({f"{hosts.count(h)} ranks on host {h} with {c} CUDA "
                      "card(s)" for c, h in seen
                      if backend == "nccl" and hosts.count(h) > int(c)})
    if crowded:
        # every rank refuses alike; rank 0, which serves the store, leaves
        # only once every rank has read it
        try:
            store.set(f"read/{rank}", "")
            if rank == 0:
                store.wait([f"read/{q}" for q in range(world)])
        except dist.DistError:
            pass        # the store's server left: the refusal stands
        raise RuntimeError(
            f"nccl: {'; '.join(crowded)}.  NCCL refuses two ranks on one "
            "card: run at most one rank a card on each host, or --backend "
            "gloo, which stages device tensors through host memory")
    dev = torch.device("cpu")
    if kind == "cuda":
        dev = torch.device("cuda", hosts[:rank].count(me) % cards)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=wait)
    return RankMesh(local, rank, world, dev, backend)

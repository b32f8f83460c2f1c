"""Shard slots and the collectives between them.

Counterpart of dbg_assembly_tpu/parallel/mesh.py.  JAX drives a mesh of
devices from one process through ``shard_map``; so does the port: a
``Mesh`` is D shard slots, each with an explicit device, driven by the one
controller.  Slot d sits on ``cuda:(d mod n_cards)`` by default, so four
slots share one card where the machine has one, or on the CPU when the
caller asks for it.  The framework's axes are JAX's (SURVEY.md 2.5):
  * 'd' (data): reads-batch sharding, the analog of the reference's
    round-robin ``i % threadNum`` read assignment (DBGgraph.cpp:42);
  * k-mer space: table sharding by k-mer value, routed with all_to_all,
    the analog of ``kmer % threadNum == threadId`` (DBGgraph.cpp:148-150).

The collectives that JAX's ``shard_map`` bodies use are plain functions
here, on lists of per-slot tensors (element d on slot d's device).  Each
move between slots is one ``.to(device, non_blocking=True)``: a device
copy between slots on one card (none at all between tensors already
there), a peer copy between cards; no collective waits on the host.
``bytes_moved`` counts the bytes they carry from one slot to another.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

# bytes the collectives carried from one slot to another since import (or
# since the caller last reset it), whatever devices the slots sit on
bytes_moved = 0


class Mesh:
    """D = n shard slots, slot d on ``devices[d]`` (JAX's mesh axis 'd').

    One process holds every slot: ``first_slot`` (the global index of
    devices[0]) is 0, and sums over the slots are the caller's own.
    parallel/ranks.RankMesh has the same interface over processes."""

    first_slot = 0

    def __init__(self, devices: list[torch.device]):
        if not devices:
            raise ValueError("a mesh needs at least one slot")
        self.devices = list(devices)
        self.n = len(self.devices)

    def all_to_all(self, bufs: list[list[torch.Tensor]]):
        return all_to_all(self, bufs)

    def sum_ints(self, *values: int) -> list[int]:
        """The sums over every slot of per-slot-total ints: here, the
        values themselves."""
        return [int(v) for v in values]

    def layout(self) -> str:
        """E.g. "4 shards on 1 card" or "4 shards on the CPU"."""
        cards = {d for d in self.devices if d.type == "cuda"}
        if not cards:
            return f"{self.n} shards on the CPU"
        return (f"{self.n} shards on {len(cards)} card"
                f"{'s' if len(cards) > 1 else ''}")


def data_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A mesh of n_devices slots.  device "cuda": slot d on cuda:(d mod
    the card count), and no card raises (never a CPU fallback); "cpu":
    every slot on the CPU; "cuda:i": every slot on that card.
    n_devices=None, as in JAX's data_mesh (dbg_assembly_tpu/parallel/
    mesh.py:18), means every device: one slot a card on "cuda", and one
    slot on "cpu" or "cuda:i", which name one device."""
    dev = resolve_device(device)
    whole = dev.type == "cuda" and dev.index is None
    if n_devices is None:
        n_devices = torch.cuda.device_count() if whole else 1
    if n_devices < 1:
        raise ValueError(f"a mesh needs n_devices >= 1, not {n_devices}")
    if whole:
        cards = torch.cuda.device_count()
        return Mesh([torch.device("cuda", d % cards)
                     for d in range(n_devices)])
    return Mesh([dev] * n_devices)


def pad_to_multiple(a: np.ndarray, m: int, fill=0) -> np.ndarray:
    n = a.shape[0]
    pad = (-n) % m
    if pad == 0:
        return a
    pad_block = np.full((pad,) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad_block], axis=0)


def blocks(n: int, d: int) -> list[slice]:
    """n rows cut into d contiguous blocks, sizes as np.array_split's."""
    edges = np.cumsum([0] + [len(b) for b in np.array_split(np.arange(n),
                                                           d)])
    return [slice(a, b) for a, b in zip(edges[:-1], edges[1:])]


def shard_batch(mesh: Mesh, *arrays):
    """Each array's leading axis cut into D equal contiguous blocks, block
    d on slot d's device (JAX's P("d")).  Returns one list of D tensors an
    array.  The leading axis must divide by D (pad_to_multiple)."""
    out = []
    for a in arrays:
        t = torch.as_tensor(np.ascontiguousarray(a)) \
            if isinstance(a, np.ndarray) else a
        if t.shape[0] % mesh.n:
            raise ValueError(f"leading axis {t.shape[0]} does not divide "
                             f"into {mesh.n} shards; pad_to_multiple first")
        out.append([blk.contiguous().to(d) for blk, d in
                    zip(t.tensor_split(mesh.n), mesh.devices)])
    return tuple(out)


def _move(x: torch.Tensor, device: torch.device, moved: bool) -> torch.Tensor:
    """x on ``device``; its bytes count when it leaves its slot."""
    global bytes_moved
    if moved:
        bytes_moved += x.numel() * x.element_size()
    return x.to(device, non_blocking=True)


def all_to_all(mesh: Mesh, bufs: list[list[torch.Tensor]]):
    """bufs[s][t] is what slot s sends slot t (sizes may differ).  Returns
    recv with recv[t] = the concatenation over s, in source order, of
    bufs[s][t], on slot t's device."""
    D = mesh.n
    return [torch.cat([_move(bufs[s][t], mesh.devices[t], s != t)
                       for s in range(D)]) for t in range(D)]


def all_gather(mesh: Mesh, xs: list[torch.Tensor]):
    """Every slot gets the concatenation of all slots' xs, in slot order
    (JAX's all_gather(tiled=True))."""
    return [gather(mesh, xs, t) for t in range(mesh.n)]


def psum(mesh: Mesh, xs: list[torch.Tensor]):
    """Every slot gets the elementwise sum of all slots' xs."""
    return [reduce(mesh, xs, t) for t in range(mesh.n)]


def psum_scatter(mesh: Mesh, xs: list[torch.Tensor], sizes: list[int]):
    """xs[s] is [sum(sizes), ...] on slot s; slot t gets the sum over s of
    rows [off_t, off_t + sizes[t]) of xs[s] (JAX's psum_scatter(tiled=
    True), with ragged blocks)."""
    parts = [x.split(sizes) for x in xs]
    return [reduce(mesh, [p[t] for p in parts], t) for t in range(mesh.n)]


def ppermute(mesh: Mesh, xs: list[torch.Tensor], perm: list[tuple[int, int]]):
    """out[dst] = xs[src] on dst's device for each (src, dst) of perm."""
    out = [None] * mesh.n
    for src, dst in perm:
        out[dst] = _move(xs[src], mesh.devices[dst], src != dst)
    return out


def broadcast(mesh: Mesh, x: torch.Tensor, src: int):
    """x of slot src on every slot: all_gather with one sender, what a
    probe issued by one slot sends the table's slots."""
    return [_move(x, dev, t != src) for t, dev in enumerate(mesh.devices)]


def reduce(mesh: Mesh, xs: list[torch.Tensor], dst: int) -> torch.Tensor:
    """The sum of all slots' xs on slot dst: psum_scatter with one
    receiver, what answers a probe issued by one slot."""
    dev = mesh.devices[dst]
    acc = xs[dst].clone()
    for s, x in enumerate(xs):
        if s != dst:
            acc += _move(x, dev, True)
    return acc


def gather(mesh: Mesh, xs: list[torch.Tensor], dst: int = 0) -> torch.Tensor:
    """The concatenation of all slots' xs, in slot order, on slot dst."""
    dev = mesh.devices[dst]
    return torch.cat([_move(x, dev, s != dst) for s, x in enumerate(xs)])

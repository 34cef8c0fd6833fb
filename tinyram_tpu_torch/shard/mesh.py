"""The device mesh of the sharded prover: one process per rank.

Port of `tinyram_tpu/shard/mesh.py`.  The JAX package runs one program
over a `jax.sharding.Mesh` with the axis "chips" inside one process; here
every rank is a process of its own (SPMD over `torch.distributed`), so
every device has its own host Python, and a `Mesh` is what one rank
knows: the process group of the "chips" axis, its size D, this rank and
this rank's device.  A "block-sharded global array" of the JAX package is
the rank's local block, and the JAX collectives become methods here:

  jax.lax.all_to_all(x, split, concat, tiled=True)  ->  `Mesh.all_to_all`
  jax.lax.all_gather(x)                              ->  `Mesh.all_gather`
  the collective-permute of a rotation (GSPMD)       ->  `Mesh.permute`
  the sum over the row axis of a sharded reduction   ->  `Mesh.field_sum`

The backend follows the map from ranks to devices and is chosen before
anything runs (`backend_for`): NCCL when every rank has a card of its own,
gloo on the CPU and when ranks share one card (NCCL refuses two ranks on
one GPU).  Gloo takes CUDA tensors in every collective used here (checked
on an H100 with PyTorch 2.11) and copies them through host memory itself:
that copy is the transport of ranks that share a card.

Every collective counts what this rank sends to the other ranks into
`utils.profiling.counters` as "mesh.<kind>" (all_to_all, all_gather,
permute, broadcast): field elements (a limb tensor's elements over its 16
limbs; a broadcast's ints), with the seconds it took (the device is
synchronized before and after it, so they are the collective's own).
"mesh.unsplit" counts the columns of domain transforms the mesh did not
split (`poly/domain.py`).  The prover files them per phase.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..field.params import N_LIMBS
from ..utils.profiling import counters

# `all_gather_into_tensor` under its newer name where the installed
# PyTorch has it
_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def rank_devices(n_devices: int, device=None) -> list[torch.device]:
    """The device of each of `n_devices` ranks: every rank on `device` if
    given, else rank r on card r mod the card count (all ranks on the one
    card of a one-card machine).  Raises when a card is asked for and
    there is none."""
    if device is not None:
        return [torch.device(device)] * n_devices
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks on the CPU")
    count = torch.cuda.device_count()
    return [torch.device("cuda", r % count) for r in range(n_devices)]


def _canonical(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    return dev


def backend_for(devices) -> str:
    """"nccl" when every rank has a card of its own, else "gloo" (the CPU,
    or ranks that share a card)."""
    devs = [_canonical(torch.device(d)) for d in devices]
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


@dataclass(eq=False)
class Mesh:
    """One rank's view of a 1-D mesh (axis "chips") of `size` ranks.
    Hashed by identity: a cache keyed by a mesh keeps one entry per mesh,
    as the JAX package's caches keyed by `jax.sharding.Mesh` do."""

    group: dist.ProcessGroup | None  # None: the default process group
    size: int
    rank: int
    device: torch.device
    backend: str

    # ------------------------------------------------------------ helpers

    def block(self, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
        """This rank's block of `x` (replicated on every rank) along `axis`:
        the `rank`-th of `size` equal parts."""
        n = x.shape[axis]
        if n % self.size:
            raise ValueError(f"mesh of {self.size} does not divide {n}")
        m = n // self.size
        return x.narrow(axis, self.rank * m, m)

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.time()

    def _count(self, kind: str, elements: int, t0: float) -> None:
        counters.add(f"mesh.{kind}", elements, self._sync() - t0)

    def count_unsplit(self, x: torch.Tensor) -> None:
        """Count the columns of a (16, ..., n) transform not split over
        the mesh."""
        counters.add("mesh.unsplit", x[0].numel() // x.shape[-1], 0.0)

    # -------------------------------------------------------- collectives

    def all_to_all(self, x: torch.Tensor, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """`jax.lax.all_to_all(x, "chips", split_axis, concat_axis,
        tiled=True)`: `x` is cut into `size` equal chunks along
        `split_axis`, chunk j goes to rank j, and the chunks received are
        joined along `concat_axis` in rank order.

        `all_to_all_single` splits along dim 0 only, so the split axis is
        moved to the front and made contiguous, exchanged, and the
        received chunks are moved into the concat axis."""
        nd = x.dim()
        split_axis %= nd
        concat_axis %= nd
        D = self.size
        xs = x.movedim(split_axis, 0)
        if xs.shape[0] % D:
            raise ValueError(f"mesh of {D} does not divide axis "
                             f"{split_axis} of {tuple(x.shape)}")
        send = xs.reshape(D, xs.shape[0] // D, *xs.shape[1:]).contiguous()
        got = torch.empty_like(send)
        t0 = self._sync()
        dist.all_to_all_single(got, send, group=self.group)
        self._count("all_to_all", x.numel() // N_LIMBS * (D - 1) // D, t0)
        # got[j]: rank j's chunk, axes as xs's; restore x's axis order
        # behind the rank axis, then put the rank axis before concat_axis
        y = got.movedim(1, split_axis + 1).movedim(0, concat_axis)
        shape = list(y.shape)
        shape[concat_axis:concat_axis + 2] = [D * shape[concat_axis + 1]]
        return y.reshape(shape)

    def all_gather(self, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
        """`jax.lax.all_gather(x, "chips", axis=axis, tiled=True)`: every
        rank's `x` joined along `axis` in rank order."""
        axis %= x.dim()
        send = x.movedim(axis, 0).contiguous()
        got = torch.empty((self.size * send.shape[0],) + send.shape[1:],
                          dtype=send.dtype, device=send.device)
        t0 = self._sync()
        _all_gather_single(got, send, group=self.group)
        self._count("all_gather", x.numel() // N_LIMBS * (self.size - 1), t0)
        return got.movedim(0, axis)

    def field_sum(self, x: torch.Tensor, field) -> torch.Tensor:
        """Σ over ranks of each rank's field partials `x` (16, ...), the
        same on every rank: an `all_gather` of the D partials (counted as
        one), added in rank order.  Field addition is exact, so any order
        gives the same bits; rank order keeps every rank's arithmetic the
        same."""
        parts = self.all_gather(x[None], 0)
        acc = parts[0]
        for i in range(1, self.size):
            acc = field.add(acc, parts[i])
        return acc

    def permute(self, x: torch.Tensor, dst: int, src: int) -> torch.Tensor:
        """A collective permute along the last axis: this rank sends `x`
        to rank `dst` and returns what rank `src` sent (same shape).  One
        `all_to_all_single` with one non-empty chunk each way."""
        D = self.size
        send = x.movedim(-1, 0).contiguous()
        w = send.shape[0]
        got = torch.empty_like(send)
        t0 = self._sync()
        dist.all_to_all_single(
            got, send, [w if j == src else 0 for j in range(D)],
            [w if j == dst else 0 for j in range(D)], group=self.group)
        self._count("permute",
                    x.numel() // N_LIMBS if dst != self.rank else 0, t0)
        return got.movedim(0, -1)

    def broadcast_ints(self, values: list[int] | None, count: int,
                       n_bytes: int = 32) -> list[int]:
        """Rank 0's `count` non-negative ints below 2^(8 n_bytes), on every
        rank (the others pass None)."""
        if self.rank == 0:
            raw = b"".join(int(v).to_bytes(n_bytes, "little") for v in values)
            buf = torch.frombuffer(bytearray(raw),
                                   dtype=torch.uint8).to(self.device)
        else:
            buf = torch.empty(count * n_bytes, dtype=torch.uint8,
                              device=self.device)
        t0 = self._sync()
        dist.broadcast(buf, 0, group=self.group)
        self._count("broadcast",
                    count * (self.size - 1) if self.rank == 0 else 0, t0)
        raw = bytes(buf.cpu().numpy())
        return [int.from_bytes(raw[i:i + n_bytes], "little")
                for i in range(0, len(raw), n_bytes)]

    def barrier(self) -> None:
        dist.barrier(group=self.group)


class MeshRng:
    """The caller's `rng` drawn on rank 0, every draw broadcast to all
    ranks: the ranks of a sharded proof use the same blinds, drawn in the
    single-device order, so a seeded `rng` gives the single-device bytes.
    `randbelow_many` draws a batch with one broadcast."""

    def __init__(self, mesh: Mesh, rng):
        self.mesh = mesh
        self.rng = rng

    def randbelow_many(self, n: int, count: int) -> list[int]:
        if count == 0:
            return []
        vals = ([self.rng.randbelow(n) for _ in range(count)]
                if self.mesh.rank == 0 else None)
        return self.mesh.broadcast_ints(vals, count,
                                        max(1, -(-n.bit_length() // 8)))

    def randbelow(self, n: int) -> int:
        return self.randbelow_many(n, 1)[0]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """This rank's `Mesh` over the running process group (or one started
    here from the environment `torchrun` sets): `n_devices` ranks, the
    group's size when None.  `devices[r]` is rank r's device (default
    `rank_devices`); the group's backend must be `backend_for(devices)`."""
    if not dist.is_initialized():
        world = int(os.environ["WORLD_SIZE"])
        devs = [torch.device(d) for d in devices] if devices is not None \
            else rank_devices(world)
        dist.init_process_group(backend_for(devs), init_method="env://")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks needs a process group "
                         f"of that size, not {world}")
    devs = [torch.device(d) for d in devices] if devices is not None \
        else rank_devices(world)
    if len(devs) != world:
        raise ValueError(f"{len(devs)} devices for {world} ranks")
    backend = backend_for(devs)
    if dist.get_backend() != backend:
        raise ValueError(f"ranks on {[str(d) for d in devs]} take the "
                         f"{backend} backend, the group runs "
                         f"{dist.get_backend()}")
    rank = dist.get_rank()
    dev = _canonical(devs[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.empty(0, device=dev)
    return Mesh(group=None, size=world, rank=rank, device=dev, backend=backend)

"""A mesh of torch devices in one process, and the collectives over it
(counterpart of astroburst_tpu/parallel/mesh.py:make_mesh and of the
``jax.lax`` collectives its ``shard_map`` bodies call).

The JAX package runs one controller: ``shard_map`` over a ``Mesh`` of
devices in one process. The port keeps that model. A ``Mesh`` is a
grid of ``torch.device``s with named axes, and a device may repeat: a
card's machine with one H100 runs 4 shards on ``cuda:0``, the CPU
tests 8 on the CPU. A sharded value is a list of per-shard tensors in
the mesh's flat (row-major) order, each on its shard's device
(``Sharded``).

Data crosses shards only in the collectives below: ``ppermute``,
``all_to_all``, ``psum`` / ``pmin`` / ``pmax`` and ``broadcast``. Each
one copies, also between two shards of one device: ``.to(device)``
returns the same tensor there, and one shard's later write would reach
the other. Each adds the elements it moved to ``mesh.moved[op]`` (a
piece a shard keeps is not moved) and one to ``mesh.calls[op]``; the
contract tests read these counts. Work for a shard is launched under
``mesh.on(i)`` (``torch.cuda.device`` of its card), on that device's
current stream; a copy between two cards is a peer copy that PyTorch
orders after the work queued on both.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from astroburst_tpu_torch.runtime.device import cuda_device


class Mesh:
    """Named axes over an ndarray of ``torch.device``s (repeats allowed)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {devices.shape} for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.moved: Counter = Counter()
        self.calls: Counter = Counter()

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, i: int) -> torch.device:
        """The device of flat shard ``i``."""
        return self.devices.flat[i]

    def axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"no mesh axis {sorted(unknown)} in "
                             f"{self.axis_names}")
        return axes

    def extent(self, axes) -> int:
        """The number of blocks a dim split over ``axes`` has."""
        return int(np.prod([self.shape[a] for a in self.axes(axes)]))

    def index(self, i: int, axes) -> int:
        """Flat shard ``i``'s block index over ``axes``, row-major in
        the order ``axes`` are given."""
        coords = np.unravel_index(i, self.devices.shape)
        idx = 0
        for a in self.axes(axes):
            k = self.axis_names.index(a)
            idx = idx * self.devices.shape[k] + int(coords[k])
        return idx

    def groups(self, axes) -> list:
        """The shards that share every other axis's coordinate, one list
        a group, each ordered by its index over ``axes``."""
        axes = self.axes(axes)
        rest = [a for a in self.axis_names if a not in axes]
        out = {}
        for i in range(self.size):
            out.setdefault(self.index(i, rest), []).append(i)
        return [sorted(g, key=lambda i: self.index(i, axes))
                for _, g in sorted(out.items())]

    def on(self, i: int):
        """Launch context of shard ``i``: its card current, or nothing
        on the CPU."""
        dev = self.device(i)
        return torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext()

    def reset_counts(self) -> None:
        self.moved.clear()
        self.calls.clear()

    # ---- collectives ---------------------------------------------------

    def _copy(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return x.to(self.device(i), copy=True)

    def _count(self, op: str, elements: int) -> None:
        self.calls[op] += 1
        self.moved[op] += int(elements)

    def ppermute(self, xs: Sequence, axes, perm) -> list:
        """``jax.lax.ppermute``: within each group over ``axes``, member
        ``dst`` receives a copy of member ``src``'s tensor for each
        (src, dst) of ``perm``; a member that receives nothing gets
        None (JAX gives zeros: every caller here selects the edge
        instead)."""
        out = [None] * self.size
        moved = 0
        for g in self.groups(axes):
            for src, dst in perm:
                out[g[dst]] = self._copy(xs[g[src]], g[dst])
                moved += xs[g[src]].numel()
        self._count("ppermute", moved)
        return out

    def all_to_all(self, xs: Sequence, axis: str, split_dim: int,
                   concat_dim: int) -> list:
        """``jax.lax.all_to_all(tiled=True)`` over one axis: each member
        splits its tensor into P equal pieces along ``split_dim``; piece
        j goes to member j, which concatenates what it receives along
        ``concat_dim`` in the senders' order."""
        out = [None] * self.size
        moved = 0
        for g in self.groups(axis):
            p = len(g)
            pieces = [torch.tensor_split(xs[i], p, dim=split_dim)
                      for i in g]
            for j, dst in enumerate(g):
                recv = []
                for s, src in enumerate(g):
                    piece = pieces[s][j]
                    if src != dst:
                        moved += piece.numel()
                    recv.append(self._copy(piece, dst))
                out[dst] = torch.cat(recv, dim=concat_dim)
        self._count("all_to_all", moved)
        return out

    def _reduce(self, op: str, xs: Sequence, axes,
                fold: Callable) -> list:
        out = [None] * self.size
        moved = 0
        for g in self.groups(axes):
            acc = self._copy(xs[g[0]], g[0])
            for i in g[1:]:      # in the group's order: deterministic
                acc = fold(acc, xs[i].to(acc.device))
                moved += xs[i].numel()
            for i in g:
                out[i] = self._copy(acc, i)
                moved += acc.numel() if i != g[0] else 0
        self._count(op, moved)
        return out

    def psum(self, xs: Sequence, axes) -> list:
        return self._reduce("psum", xs, axes, torch.add)

    def pmin(self, xs: Sequence, axes) -> list:
        return self._reduce("pmin", xs, axes, torch.minimum)

    def pmax(self, xs: Sequence, axes) -> list:
        return self._reduce("pmax", xs, axes, torch.maximum)

    def broadcast(self, x: torch.Tensor) -> list:
        """A copy of ``x`` on every shard."""
        self._count("broadcast", x.numel() * self.size)
        return [self._copy(x, i) for i in range(self.size)]


@dataclass
class Sharded:
    """A tensor over a mesh: ``parts[i]`` lives on flat shard i. ``dim``
    is split over ``axes`` in blocks (block ``mesh.index(i, axes)``);
    shards that differ only in other axes hold the same block. ``dim``
    None: every shard holds the whole. ``length`` is the dim's extent in
    the image (the blocks may be padded past it)."""
    mesh: Mesh
    parts: list
    dim: Optional[int]
    axes: Tuple[str, ...]
    length: int

    def blocks(self) -> list:
        """One part per block, in block order."""
        if self.dim is None:
            return [self.parts[0]]
        first = {}
        for i, p in enumerate(self.parts):
            first.setdefault(self.mesh.index(i, self.axes), p)
        return [first[b] for b in sorted(first)]

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the first shard's by default):
        assembled only where a caller asks for it."""
        device = self.parts[0].device if device is None else device
        blocks = [b.to(device) for b in self.blocks()]
        if self.dim is None:
            return blocks[0]
        return torch.cat(blocks, dim=self.dim).narrow(self.dim, 0,
                                                      self.length)


def block_bounds(length: int, parts: int) -> list:
    """[(start, stop)] of ``parts`` blocks of ceil(length / parts) over
    [0, length); the last ones may be short or empty."""
    size = -(-length // parts)
    return [(min(b * size, length), min((b + 1) * size, length))
            for b in range(parts)]


def shard(mesh: Mesh, x: torch.Tensor, dim: int, axes,
          pad_edge: bool = False) -> Sharded:
    """Place ``x`` on the mesh, ``dim`` split over ``axes``: each shard
    gets a copy of its block (the placement, as ``jax.device_put`` with
    a NamedSharding; not a collective). ``pad_edge`` makes every block
    ceil(length / P) long by replicating the last index, as the JAX
    package pads row shards (``mode="edge"``)."""
    axes = mesh.axes(axes)
    p = mesh.extent(axes)
    length = x.shape[dim]
    if pad_edge:
        size = -(-length // p)
        idx = torch.clamp(torch.arange(size * p, device=x.device),
                          max=length - 1)
        x = x.index_select(dim, idx)
        bounds = [(b * size, (b + 1) * size) for b in range(p)]
    else:
        bounds = block_bounds(length, p)
    parts = []
    for i in range(mesh.size):
        b0, b1 = bounds[mesh.index(i, axes)]
        parts.append(x.narrow(dim, b0, b1 - b0).to(mesh.device(i),
                                                   copy=True))
    return Sharded(mesh, parts, dim, axes, length)


def as_sharded(mesh: Mesh, x, dim: int, axes,
               pad_edge: bool = False) -> Sharded:
    """``x`` with ``dim`` split over ``axes``: a Sharded of that layout
    as it is (another layout raises), a tensor placed by ``shard``."""
    if isinstance(x, Sharded):
        if x.dim != dim or x.axes != mesh.axes(axes):
            raise ValueError(f"expected dim {dim} split over {axes}, got "
                             f"dim {x.dim} over {x.axes}")
        return x
    return shard(mesh, x, dim, axes, pad_edge)


def make_mesh(devices=None, axis_names: Tuple[str, ...] = ("frames", "rows"),
              shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """Build a mesh.

    ``devices``: a sequence of devices (repeats allowed), or an int n
    (n shards over the card's devices in turn), or None: one shard per
    card, or ``prod(shape)`` shards over the cards in turn. Without a
    card, None and an int raise (``cuda_device``): a mesh runs on the
    CPU only when the caller lists CPU devices. With no ``shape``,
    every shard goes to the first axis, as in the JAX package.
    """
    if devices is None or isinstance(devices, int):
        cuda_device()
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        n = devices if isinstance(devices, int) else (
            int(np.prod(shape)) if shape is not None else len(cards))
        devices = [cards[i % len(cards)] for i in range(n)]
    devs = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devs),) + (1,) * (len(axis_names) - 1)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), tuple(axis_names))


def on_shards(mesh: Mesh, fn: Callable, *per_shard) -> list:
    """``fn(i, *args_i)`` for each shard i under ``mesh.on(i)``, where
    each of ``per_shard`` is a list of per-shard values (``Sharded``
    parts); the results in shard order."""
    out = []
    for i in range(mesh.size):
        with mesh.on(i):
            out.append(fn(i, *(v[i] for v in per_shard)))
    return out

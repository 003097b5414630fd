"""Flat replica space: the persistent packed parameter layout the sync engine
runs on, the twin of ``repro/core/flatspace.py``.

The dense replica tree is packed ONCE into a contiguous ``(R, n_rows, 128)``
fp32 buffer, ``n_rows`` padded up to a whole number of ``block`` rows, and
every background sync is one kernel launch over that buffer. The layout,
the padding rule and the leaf order (sorted dict keys, repro_torch/tree.py)
are the JAX package's, so a packed buffer holds the same bytes in both.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch import tree as T

Tree = Any

LANE = 128  # last dim of every flat buffer (the TPU lane width in the reference)
DEFAULT_BLOCK = 256  # rows per block; n_rows is a multiple of it


@dataclasses.dataclass(frozen=True)
class FlatSpace:
    """Static description of the packed layout of one replica's tree."""

    template: Tree  # the tree's structure, with None at the leaves
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]
    total: int  # live parameters per replica
    n_rows: int  # padded rows of LANE floats (multiple of `block`)
    block: int

    @classmethod
    def from_tree(cls, tree: Tree, block: int = DEFAULT_BLOCK) -> "FlatSpace":
        leaves = T.leaves(tree)
        if not leaves:
            raise ValueError("FlatSpace needs at least one leaf")
        packable = {torch.float32, torch.bfloat16, torch.float16}
        bad = sorted({str(l.dtype) for l in leaves if l.dtype not in packable})
        if bad:
            raise TypeError(
                f"FlatSpace packs through fp32, which is lossless only for "
                f"f32/bf16/f16 leaves; got {bad}")
        shapes = tuple(tuple(l.shape) for l in leaves)
        sizes = tuple(math.prod(s) for s in shapes)
        total = sum(sizes)
        n_rows = max(1, -(-total // (LANE * block))) * block
        return cls(T.map(lambda l: None, tree), shapes,
                   tuple(l.dtype for l in leaves), sizes, total, n_rows, block)

    @property
    def slots(self) -> int:
        """fp32 slots per replica plane (>= total; the tail is zero padding)."""
        return self.n_rows * LANE

    # -- single replica -----------------------------------------------------
    def pack(self, tree: Tree) -> torch.Tensor:
        """Tree -> contiguous (n_rows, LANE) fp32 plane."""
        return self.pack_stack(T.map(lambda l: l.unsqueeze(0), tree))[0]

    def unpack(self, plane: torch.Tensor) -> Tree:
        """(n_rows, LANE) plane -> tree with the original shapes and dtypes."""
        return T.map(lambda l: l[0], self.unpack_stack(plane.unsqueeze(0)))

    # -- replica stacks -----------------------------------------------------
    def pack_stack(self, stack: Tree) -> torch.Tensor:
        """Tree with leading replica dim R -> new (R, n_rows, LANE) fp32 buffer."""
        leaves = T.leaves(stack)
        R = leaves[0].shape[0]
        buf = leaves[0].new_zeros((R, self.slots), dtype=torch.float32)
        off = 0
        for l, size in zip(leaves, self.sizes):
            buf[:, off:off + size] = l.reshape(R, size)
            off += size
        return buf.reshape(R, self.n_rows, LANE)

    def unpack_stack(self, buf: torch.Tensor) -> Tree:
        """(R, n_rows, LANE) buffer -> tree stack with leading replica dim.
        Leaves are views of ``buf`` where the dtype is fp32."""
        R = buf.shape[0]
        vec = buf.reshape(R, -1)
        out, off = [], 0
        for shape, dtype, size in zip(self.shapes, self.dtypes, self.sizes):
            out.append(vec[:, off:off + size].reshape((R,) + shape).to(dtype))
            off += size
        return T.unflatten(self.template, out)

    def unpack_replica(self, buf: torch.Tensor, i: int) -> Tree:
        return self.unpack(buf[i])

    def broadcast(self, tree: Tree, n_replicas: int) -> torch.Tensor:
        """Pack one tree and replicate it into a fresh (R, n_rows, LANE) buffer."""
        plane = self.pack(tree)
        return plane.unsqueeze(0).expand((n_replicas,) + plane.shape).clone()

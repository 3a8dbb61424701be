"""Device mesh over the ranks of `torch.distributed` (port of
`rt_depth_map_tpu/parallel/mesh.py`).

One process is one rank and holds one device. The JAX mesh's axes become a
2-D grid of the world's ranks, rank = data index * space size + space
index: "data" shards independent camera streams or frame batches, "space"
shards image-width tiles, whose halos and carries the exchange primitives
of `parallel/tiled_bm.py` send between the ranks of a space group. Each
row and each column of the grid gets a process group (`dist.new_group`),
made by every rank in one order. A world of one rank with no process group
is a valid (1, 1) mesh: there every collective is the identity.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist


class Mesh:
    """The rank grid as one rank sees it: `shape[axis]`, `axis_index(axis)`,
    `group(axis)` (None for an axis of size 1) and `axis_ranks(axis)` (the
    global ranks of this rank's group along the axis, by index)."""

    def __init__(self, shape: Dict[str, int], rank: int,
                 ranks: Dict[str, List[int]], groups: Dict[str, object]):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.rank = rank
        self._ranks = ranks
        self._groups = groups

    def axis_index(self, axis: str) -> int:
        return self._ranks[axis].index(self.rank)

    def axis_ranks(self, axis: str) -> List[int]:
        return list(self._ranks[axis])

    def group(self, axis: str):
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank})"


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Sequence[str] = ("data", "space")) -> Mesh:
    """Mesh over (data, space) of the initialised world. Default: every rank
    on the space axis (the most tile parallelism for one stream). Every
    rank must call it, with the same arguments: it makes the groups."""
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    if shape is None:
        shape = (1, world)
    if len(shape) != 2 or len(axis_names) != 2:
        raise ValueError(f"mesh shape {shape} over axes {tuple(axis_names)}: "
                         "two axes")
    nd, ns = int(shape[0]), int(shape[1])
    if nd * ns != world:
        raise ValueError(f"mesh shape {tuple(shape)} != {world} ranks")
    first, second = axis_names
    rows = [[i * ns + j for j in range(ns)] for i in range(nd)]
    cols = [[i * ns + j for i in range(nd)] for j in range(ns)]
    ranks = {first: cols[rank % ns], second: rows[rank // ns]}
    groups = {first: None, second: None}
    # new_group is collective over the world: every rank makes every group,
    # in one order; an axis of size 1 needs none
    if initialised and ns > 1:
        for r in rows:
            g = dist.new_group(r)
            if rank in r:
                groups[second] = g
    if initialised and nd > 1:
        for c in cols:
            g = dist.new_group(c)
            if rank in c:
                groups[first] = g
    return Mesh({first: nd, second: ns}, rank, ranks, groups)

"""Flat structure-of-arrays BSP index (port of
``vector_database_tpu/models/bsp.py``).

Node ids are dense (level-major order of appearance); vectors are stored
leaf-major, so each leaf bucket is a contiguous ``[start, start+count)``
slice. ``save``/``load`` use the JAX package's npz format, so an index
saved by either package loads into the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_ARRAYS = ("dim", "mid", "low", "high", "leaf_start", "leaf_count",
           "vectors", "orig_row")


@dataclasses.dataclass
class BSPIndex:
    """A built variance-split BSP tree over ``n`` vectors of dim ``d``.

    Node table (all ``[num_nodes]``):
      dim:  split dimension; -1 for leaves, -2 for tie-partitioned nodes.
      mid:  split plane (the segment mean on ``dim``); 0 for leaves.
      low / high: dense child node ids; -1 for leaves.
      leaf_start / leaf_count: contiguous slice of the leaf-major arrays;
        (0, 0) for internal nodes.

    Point data (leaf-major order):
      vectors: ``[n, d]`` float32.
      orig_row: ``[n]`` int32, the original input row of each sorted row.
    """

    dim: torch.Tensor
    mid: torch.Tensor
    low: torch.Tensor
    high: torch.Tensor
    leaf_start: torch.Tensor
    leaf_count: torch.Tensor
    vectors: torch.Tensor
    orig_row: torch.Tensor
    depth: int
    leaf_cap: int
    num_leaves: int
    # plane-tie routing of the build: False for builder trees
    ties_high: bool = False

    @property
    def num_nodes(self) -> int:
        return self.dim.shape[0]

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def d(self) -> int:
        return self.vectors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            **{name: getattr(self, name).cpu().numpy() for name in _ARRAYS},
            meta=np.array(
                [self.depth, self.leaf_cap, self.num_leaves,
                 int(self.ties_high)],
                dtype=np.int64,
            ),
        )

    @classmethod
    def from_numpy(cls, arrays, meta, *, device=None) -> "BSPIndex":
        """Index from numpy node/point arrays (the npz keys) and
        ``meta = [depth, leaf_cap, num_leaves(, ties_high)]``."""
        meta = [int(v) for v in meta]
        depth, leaf_cap, num_leaves = meta[:3]
        return cls(
            **{name: torch.tensor(np.asarray(arrays[name]),
                                  device=device)
               for name in _ARRAYS},
            depth=depth,
            leaf_cap=leaf_cap,
            num_leaves=num_leaves,
            ties_high=bool(meta[3]) if len(meta) > 3 else False,
        )

    @classmethod
    def load(cls, path: str, *, device=None) -> "BSPIndex":
        path = str(path)
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            return cls.from_numpy(z, z["meta"], device=device)

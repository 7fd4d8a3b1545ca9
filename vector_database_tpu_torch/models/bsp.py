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

from vector_database_tpu_torch.utils.device import resolve_device

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
        ``meta = [depth, leaf_cap, num_leaves(, ties_high)]``, on
        ``device`` (default: the card, ``cuda``)."""
        device = resolve_device(device)
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
        """Load an npz written by either package's ``save``, onto
        ``device`` (default: the card, ``cuda``)."""
        path = str(path)
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            return cls.from_numpy(z, z["meta"], device=device)

    def heap_rows(self):
        """Reconstruct reference-style heap range ids for export parity.

        Yields ``(range_id, dimension, mid, id)`` rows in the shape of the
        reference CSV export ``RangeID,Dimension,Mid,ID``
        (Program.cs:80,145-150): internal nodes carry (dimension, mid),
        leaves carry ``dimension = -1`` and the vector id. Only defined for
        ``leaf_cap == 1`` trees (singleton leaves, the reference's shape).
        """
        dim, mid, low, high, start, orig = (
            getattr(self, name).cpu().numpy() for name in
            ("dim", "mid", "low", "high", "leaf_start", "orig_row"))
        stack = [(0, 0)]  # (dense node, heap id)
        while stack:
            node, heap = stack.pop()
            if dim[node] == -1:
                yield heap, -1, 0.0, int(orig[start[node]])
            else:
                # dim -2 = id-partitioned node (the reference exports NULL
                # Dimension/Mid for these, DDL.sql:193-194)
                yield heap, int(dim[node]), float(mid[node]), -1
                stack.append((int(low[node]), 2 * heap + 1))
                stack.append((int(high[node]), 2 * heap + 2))

    @classmethod
    def from_heap_rows(cls, rows, vectors, *, ids=None,
                       ties_high: bool = False, device=None):
        """Rebuild an index from reference-style heap export rows: the
        migration path for indexes built by the reference itself.

        ``rows`` is an iterable of ``(range_id, dimension, mid, id)`` in
        the reference's persisted shapes: the CSV export
        ``RangeID,Dimension,Mid,ID`` (Program.cs:145-150) or
        ``dbo.TextIndex`` rows (DDL.sql:209-227). Accepted per row:

        - ``dimension >= 0``: internal split node (``mid`` is the plane;
          the reference's internal ``id``, its mean-id tie-break metadata,
          Stats.cs:26, is build-time-only and ignored);
        - ``dimension == -1``: singleton leaf, ``id`` is the vector id
          (IndexBuilder.cs:81-88);
        - ``dimension == -2``: this package's dual-descent export of
          id-partitioned nodes;
        - ``dimension`` None/empty/"NULL" (the SQL NULL-Dimension form,
          DDL.sql:190-199): a leaf when ``id`` is set, an id-partitioned
          dual node otherwise.

        ``vectors`` is the ``[n, d]`` float array the exported ids index
        (the reference's vector ids). By default leaf ids are row positions
        into ``vectors``; pass ``ids`` (the ``int[n]`` array
        ``load_vectors_csv`` returns) when the export's vector ids are not
        positional: leaf ids are then remapped through it, and the served
        row numbers refer to positions in ``vectors``. A dump spanning
        several documents (``dbo.TextIndex`` is keyed (RangeID, DocID), so
        RangeIDs repeat across documents) must be imported one document at
        a time: duplicate range ids raise.

        Children are located by heap numbering (``2r+1``/``2r+2``,
        IndexBuilder.cs:99-105) and the sparse heap ids are compacted to
        the dense layout; rows come out leaf-major, so the result serves
        through every query path like a natively built tree.
        ``from_heap_rows(idx.heap_rows(), ...)`` reproduces
        ``idx.heap_rows()`` row for row. The index goes to ``device``
        (default: where a tensor ``vectors`` lies, else the card).
        """

        def _opt(x, none_val):
            if x is None:
                return none_val
            if isinstance(x, str):
                s = x.strip()
                if s == "" or s.upper() == "NULL":
                    return none_val
                x = s
            return x

        table = {}
        for r in rows:
            heap = int(r[0])
            if heap in table:
                raise ValueError(
                    f"duplicate range id {heap} in export: a "
                    "dbo.TextIndex dump spanning documents must be "
                    "imported one DocID at a time"
                )
            dim_v = _opt(r[1], None)
            mid_v = float(_opt(r[2], 0.0))
            vid_v = int(_opt(r[3], -1))
            table[heap] = (None if dim_v is None else int(dim_v),
                           mid_v, vid_v)
        if 0 not in table:
            raise ValueError("no root row (RangeID 0) in export")
        device = resolve_device(device, vectors)
        vec_np = vectors.detach().cpu().numpy() \
            if isinstance(vectors, torch.Tensor) else vectors
        vec_np = np.asarray(vec_np, dtype=np.float32)
        n, d = vec_np.shape
        pos_of = None
        if ids is not None:
            ids_np = np.asarray(ids, dtype=np.int64)
            if ids_np.shape != (n,):
                raise ValueError(
                    f"ids has shape {ids_np.shape}, expected ({n},)"
                )
            if len(np.unique(ids_np)) != n:
                raise ValueError("duplicate vector id in ids")
            pos_of = {int(v): i for i, v in enumerate(ids_np)}

        # preorder walk: dense ids in visit order (children are resolved
        # by heap arithmetic, so one pass suffices)
        dims, mids, lows, highs = [], [], [], []
        lstart, lcount, orig = [], [], []
        depth_max = 0
        stack = [(0, 0)]
        dense_of = {}
        while stack:
            heap, hdepth = stack.pop()
            dim_v, mid_v, vid_v = table[heap]
            node = len(dims)
            dense_of[heap] = node
            depth_max = max(depth_max, hdepth)
            lo_h, hi_h = 2 * heap + 1, 2 * heap + 2
            has_children = lo_h in table or hi_h in table
            if dim_v is None:
                # SQL NULL-dimension row: leaf iff it carries a vector id
                dim_v = -2 if (vid_v < 0 or has_children) else -1
            if dim_v == -1:
                if has_children:
                    raise ValueError(f"leaf range {heap} has children")
                if pos_of is not None:
                    if vid_v not in pos_of:
                        raise ValueError(
                            f"leaf range {heap}: vector id {vid_v} not "
                            "present in ids"
                        )
                    vid_v = pos_of[vid_v]
                if not (0 <= vid_v < n):
                    raise ValueError(
                        f"leaf range {heap}: vector id {vid_v} outside "
                        f"[0, {n})"
                    )
                dims.append(-1)
                mids.append(0.0)
                lows.append(-1)
                highs.append(-1)
                lstart.append(len(orig))
                lcount.append(1)
                orig.append(vid_v)
            else:
                if lo_h not in table or hi_h not in table:
                    raise ValueError(
                        f"internal range {heap} is missing a child "
                        f"({lo_h}/{hi_h})"
                    )
                if dim_v != -2 and not (0 <= dim_v < d):
                    # a wrong export/vectors pairing would otherwise
                    # serve silently wrong results
                    raise ValueError(
                        f"internal range {heap}: split dimension "
                        f"{dim_v} outside [0, {d})"
                    )
                dims.append(int(dim_v))
                mids.append(mid_v)
                lows.append(-1)  # patched when the child is visited
                highs.append(-1)
                lstart.append(0)
                lcount.append(0)
                # push low last so it is visited first (preorder)
                stack.append((hi_h, hdepth + 1))
                stack.append((lo_h, hdepth + 1))
            if heap:  # patch the parent's child pointer
                parent = dense_of[(heap - 1) // 2]
                if heap % 2 == 1:
                    lows[parent] = node
                else:
                    highs[parent] = node
        if len(orig) != n:
            raise ValueError(
                f"export has {len(orig)} leaves but vectors has {n} rows"
            )
        orig_np = np.asarray(orig, dtype=np.int32)
        if len(np.unique(orig_np)) != n:
            raise ValueError("duplicate vector id across leaves")
        return cls.from_numpy(
            dict(dim=np.asarray(dims, np.int32),
                 mid=np.asarray(mids, np.float32),
                 low=np.asarray(lows, np.int32),
                 high=np.asarray(highs, np.int32),
                 leaf_start=np.asarray(lstart, np.int32),
                 leaf_count=np.asarray(lcount, np.int32),
                 vectors=vec_np[orig_np], orig_row=orig_np),
            [depth_max + 1, 1, n, int(ties_high)], device=device,
        )

    @classmethod
    def from_reference_csv(cls, path, vectors, **kw):
        """``from_heap_rows`` over a reference-format CSV file
        (``RangeID,Dimension,Mid,ID`` with or without the header line: the
        file Program.cs:145-150 writes and ``benchmarks/main_test.py``
        mirrors). Pass ``ids=`` (from ``load_vectors_csv``) when the
        dataset export's vector ids are not positional; ``device=`` as
        ``from_heap_rows``."""

        def _rows():
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line or line[0].isalpha() or line[0] == '"':
                        continue  # header / blank
                    parts = line.split(",")
                    if len(parts) != 4:
                        raise ValueError(f"bad CSV row: {line!r}")
                    yield parts
        return cls.from_heap_rows(_rows(), vectors, **kw)

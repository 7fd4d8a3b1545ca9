"""Incremental in-memory vector index (implicit bit-trie); port of
``vector_database_tpu/models/memindex.py``.

Re-design of the reference's second product, ``MemoryVectorIndex<R>``
(reference MemoryVectorIndex/MemoryVectorIndex.cs:12-605): an exact
ε-ball index over vectors normalized into ``[-1, 1]^D``.

Structure (same idea, idiomatic Python):

- nodes are ``(low, high)`` int pairs in a flat list; leaf buckets are lists
  keyed by node id (MemoryVectorIndex.cs:594-599);
- split planes are never stored — they are the *implicit* midpoints of a
  recursive halving of ``[-1, 1]`` that cycles dimensions ``0..D-1`` and
  halves the step after each full cycle (MemoryVectorIndex.cs:114-118);
- max depth is the float32 significand width (24 cycles,
  MemoryVectorIndex.cs:604);
- ``find`` prunes with an incremental squared-distance budget: starting at
  ``distance²``, crossing away from the query along an axis subtracts
  ``delta² - prev_delta²``; a negative budget prunes the subtree
  (MemoryVectorIndex.cs:279-308). This guarantees no false negatives; final
  exactness is the predicate's job (MemoryVectorIndex.cs:237-241).

Documented deviations from the reference (intentional fixes, not ports):

- bucket splitting keeps cycling dimensions with step halving until max
  depth before declaring "bad distribution" (the reference abandons the
  split after one partial dimension cycle, MemoryVectorIndex.cs:179-219);
- ``remove`` keeps ``Count`` accurate (the reference never decrements it);
- an emptied root bucket is handled on subsequent ``add``;
- a record whose descent falls off max depth while children still exist is
  attached to the nearest reachable leaf (at most one max-depth cell away),
  so it stays findable/removable — the reference silently drops it. Exact-
  match ``find`` with ``distance=0`` may still miss such a record; any
  positive radius covers the one-cell (~2^-24) displacement.

The trie is host code, a copy of the JAX package's. For batched queries,
``find_batch`` runs the exact scan (``ops/exact.exact_ball``) on the
device, and ``to_bsp`` exports the trie as a ``BSPIndex`` for the batched
tree search; both go to the card unless the index was given ``device=``.
The BSP index of ``builder.py`` is the bulk path.
"""

from __future__ import annotations

from typing import (
    Callable, Iterable, Iterator, List, Optional, Sequence, Tuple,
)

import numpy as np
import torch

from vector_database_tpu_torch.models.bsp import BSPIndex
from vector_database_tpu_torch.ops.exact import exact_ball
from vector_database_tpu_torch.utils.device import resolve_device

MAX_DEPTH = 24  # float32 significand bits


class MemoryVectorIndex:
    """Exact ε-ball index over records with vectors normalized to [-1, 1]^D.

    Args:
      records: optional initial records.
      vector_selector: maps a record to its vector (any 1-D float sequence).
        Defaults to the identity (records *are* vectors).
      list_threshold: leaf bucket size before splitting
        (MemoryVectorIndex.cs:25).
      device: where ``find_batch`` and ``to_bsp`` put their tensors
        (default: the card).
    """

    def __init__(
        self,
        records: Optional[Iterable] = None,
        vector_selector: Optional[Callable] = None,
        list_threshold: int = 10,
        *,
        device=None,
    ):
        if list_threshold <= 0:
            raise ValueError("list_threshold must be greater than zero")
        self._device = resolve_device(device)
        self._selector = vector_selector or (lambda r: r)
        self._threshold = list_threshold
        self._entries: List[Tuple[int, int]] = []  # (low, high), -1 = none
        self._buckets: dict[int, list] = {}
        self._size = 0
        self._dim = 0
        if records is not None:
            for r in records:
                self.add(r)

    # --- basic protocol -------------------------------------------------
    def __len__(self) -> int:
        return self._size

    @property
    def count(self) -> int:
        return self._size

    def __iter__(self) -> Iterator:
        for bucket in self._buckets.values():
            yield from bucket

    def clear(self) -> None:
        self._size = 0
        self._entries.clear()
        self._buckets.clear()

    def _vec(self, record) -> np.ndarray:
        return np.asarray(self._selector(record), dtype=np.float32)

    # --- add -------------------------------------------------------------
    def add(self, record) -> None:
        """Insert a record, splitting overfull leaf buckets."""
        v = self._vec(record)
        if not self._entries:
            if v.shape[0] == 0:
                raise ValueError("invalid vector size")
            self._dim = int(v.shape[0])
            self._size = 1
            self._buckets[0] = [record]
            self._entries.append((-1, -1))
            return
        if v.shape[0] != self._dim:
            raise ValueError("invalid vector size")

        d = self._dim
        index = 0
        step = 1.0
        centers = np.zeros(d, dtype=np.float32)

        for depth in range(MAX_DEPTH):
            step /= 2
            for i in range(d):
                low, high = self._entries[index]
                if v[i] < centers[i]:
                    if low >= 0:
                        centers[i] -= step
                        index = low
                        continue
                    if high >= 0:
                        # graft a new low leaf onto a single-child node
                        new = len(self._entries)
                        self._entries[index] = (new, high)
                        self._buckets[new] = [record]
                        self._entries.append((-1, -1))
                        self._size += 1
                        return
                else:
                    if high >= 0:
                        centers[i] += step
                        index = high
                        continue
                    if low >= 0:
                        new = len(self._entries)
                        self._entries[index] = (low, new)
                        self._buckets[new] = [record]
                        self._entries.append((-1, -1))
                        self._size += 1
                        return

                # leaf
                bucket = self._buckets.setdefault(index, [])
                bucket.append(record)
                self._size += 1
                if len(bucket) <= self._threshold or depth >= MAX_DEPTH - 1:
                    return
                self._split(index, bucket, depth, i, step, centers)
                return
        # Fell off max depth during descent while the node still has
        # children. Appending here would strand the record on an internal
        # node (never yielded by _walk); the reference silently drops it
        # (MemoryVectorIndex.cs's depth loop just ends). Instead keep
        # descending into existing children until a reachable leaf: the
        # record lands at most one cell away from its exact position, and
        # Find's ε-ball contract is preserved by the exact predicate.
        low, high = self._entries[index]
        while low >= 0 or high >= 0:
            index = low if low >= 0 else high
            low, high = self._entries[index]
        self._buckets.setdefault(index, []).append(record)
        self._size += 1

    def _split(self, index, bucket, depth, i, step, centers) -> None:
        """Split an overfull bucket, creating single-child shortcut chains
        along axes where all records fall on one side."""
        del self._buckets[index]
        d = self._dim
        while depth < MAX_DEPTH:
            while i < d:
                c = centers[i]
                low_list = [r for r in bucket if self._vec(r)[i] < c]
                if not low_list:
                    centers[i] += step
                    new = len(self._entries)
                    self._entries[index] = (-1, new)
                    self._entries.append((-1, -1))
                    index = new
                elif len(low_list) == len(bucket):
                    centers[i] -= step
                    new = len(self._entries)
                    self._entries[index] = (new, -1)
                    self._entries.append((-1, -1))
                    index = new
                else:
                    # complement of low_list, NOT `>= c`: a NaN
                    # coordinate satisfies neither comparison and would
                    # silently vanish from the index (add() routes NaN
                    # high the same way — `v[i] < c` is False)
                    high_list = [
                        r for r in bucket if not (self._vec(r)[i] < c)
                    ]
                    new = len(self._entries)
                    self._entries[index] = (new, new + 1)
                    self._buckets[new] = low_list
                    self._buckets[new + 1] = high_list
                    self._entries.append((-1, -1))
                    self._entries.append((-1, -1))
                    return
                i += 1
            i = 0
            depth += 1
            step /= 2
        # bad distribution (duplicates or non-normalized input): keep the
        # oversized bucket (degraded path, MemoryVectorIndex.cs:222-225).
        self._buckets[index] = bucket

    # --- traversal core --------------------------------------------------
    def _walk(self, vector: np.ndarray, distance: float):
        """Budget-pruned DFS. Yields ``(leaf_index, path)`` for every leaf
        whose cell intersects the ε-ball; ``path`` is the ancestor node
        chain (for remove-consolidation)."""
        if not self._entries:
            return
        d = self._dim
        centers = np.zeros(d, dtype=np.float32)
        path: List[int] = []
        # action stack: ("visit", node, i, step, budget) | ("set", i, value)
        # | ("pop",)
        stack: list = [("visit", 0, 0, 1.0, float(distance) * float(distance))]
        while stack:
            action = stack.pop()
            kind = action[0]
            if kind == "set":
                centers[action[1]] = action[2]
                continue
            if kind == "pop":
                path.pop()
                continue
            _, node, i, step, budget = action
            low, high = self._entries[node]
            if low == -1 and high == -1:
                yield node, path
                continue

            c = float(centers[i])
            delta = float(vector[i]) - c
            prev_delta = max(abs(delta) - step, 0.0)
            cross = (prev_delta - delta) * (prev_delta + delta)
            half = step / 2
            ni, nstep = (0, half) if i + 1 == d else (i + 1, step)

            path.append(node)
            stack.append(("pop",))
            stack.append(("set", i, c))
            # push high second so low is visited first (stack = LIFO)
            if high != -1:
                b = budget if delta >= 0 else budget + cross
                if b >= 0:
                    stack.append(("visit", high, ni, nstep, b))
                    stack.append(("set", i, c + half))
            if low != -1:
                b = budget if delta <= 0 else budget + cross
                if b >= 0:
                    stack.append(("visit", low, ni, nstep, b))
                    stack.append(("set", i, c - half))

    # --- find ------------------------------------------------------------
    def find(
        self,
        vector,
        distance: float,
        predicate: Optional[Callable] = None,
    ) -> Iterator:
        """Yield records within ``distance`` of ``vector``.

        The index prunes far subtrees but may surface records outside the
        ball; ``predicate(record, vector)`` must verify the match (reference
        contract, MemoryVectorIndex.cs:237-241). With ``predicate=None`` an
        exact L2 check is applied.
        """
        v = np.asarray(vector, dtype=np.float32)
        if self._entries and v.shape[0] != self._dim:
            raise ValueError("invalid vector size")
        if predicate is None:
            lim = float(distance) * float(distance)
            predicate = lambda r, q: float(
                np.sum((self._vec(r) - q) ** 2)
            ) <= lim
        for leaf, _ in self._walk(v, distance):
            for record in self._buckets.get(leaf, ()):
                if predicate(record, v):
                    yield record

    def find_batch(self, queries, distance: float):
        """Exact batched ε-ball search on the device over the current
        contents.

        Returns ``(records, match)`` where ``records`` is the flat list of
        indexed records and ``match`` is a ``[Q, len(records)]`` numpy bool
        array.
        """
        records = list(self)
        if not records:
            q = np.atleast_2d(np.asarray(queries, np.float32))
            return records, np.zeros((q.shape[0], 0), dtype=bool)
        mat = torch.from_numpy(np.stack([self._vec(r) for r in records]))
        match = exact_ball(mat.to(self._device), queries, distance)
        return records, match.cpu().numpy()

    def to_bsp(self):
        """Export the trie as a device-searchable ``BSPIndex``.

        The implicit split planes (cell centers of the cycling-dimension
        halving) become explicit node ``(dim, mid)`` entries; single-child
        shortcut nodes keep their plane with an empty leaf on the missing
        side. Returns ``(index, records)`` — search results' ``rows`` index
        into ``records``. The batched lockstep search then runs on the
        device (``vector_database_tpu_torch.search``), the path for
        thousands of concurrent queries against an incrementally built
        trie.
        """
        if not self._entries:
            raise ValueError("empty index")
        d = self._dim
        dim_l, mid_l, low_l, high_l = [], [], [], []
        leaf_start_l, leaf_count_l = [], []
        records: list = []
        vec_rows: list = []
        max_depth_seen = 1

        # node ids are assigned in discovery (preorder) order
        ids = {0: 0}
        centers = np.zeros(d, np.float32)

        def alloc(node):
            if node not in ids:
                ids[node] = len(ids)
            return ids[node]

        # iterative preorder with center restore actions
        actions: list = [("visit", 0, 0, 1.0, 1)]
        while actions:
            act = actions.pop()
            if act[0] == "set":
                centers[act[1]] = act[2]
                continue
            _, node, axis, step, depth = act
            my = alloc(node)
            max_depth_seen = max(max_depth_seen, depth)
            low, high = self._entries[node]
            while len(dim_l) <= my:
                dim_l.append(-1)
                mid_l.append(0.0)
                low_l.append(-1)
                high_l.append(-1)
                leaf_start_l.append(0)
                leaf_count_l.append(0)
            if low == -1 and high == -1:
                bucket = self._buckets.get(node, [])
                leaf_start_l[my] = len(records)
                leaf_count_l[my] = len(bucket)
                for r in bucket:
                    records.append(r)
                    vec_rows.append(self._vec(r))
                continue
            c = float(centers[axis])
            half = step / 2
            nxt_axis, nxt_step = (0, half) if axis + 1 == d else (
                axis + 1, step
            )
            dim_l[my] = axis
            mid_l[my] = c
            # a missing side becomes an empty leaf node
            for side, child in (("low", low), ("high", high)):
                if child == -1:
                    child_id = len(ids)
                    ids[f"empty{child_id}"] = child_id
                    while len(dim_l) <= child_id:
                        dim_l.append(-1)
                        mid_l.append(0.0)
                        low_l.append(-1)
                        high_l.append(-1)
                        leaf_start_l.append(0)
                        leaf_count_l.append(0)
                else:
                    child_id = alloc(child)
                if side == "low":
                    low_l[my] = child_id
                else:
                    high_l[my] = child_id
                if child != -1:
                    off = -half if side == "low" else half
                    actions.append(("set", axis, c))
                    actions.append(
                        ("visit", child, nxt_axis, nxt_step, depth + 1)
                    )
                    actions.append(("set", axis, c + off))

        n = len(records)
        if n == 0:
            raise ValueError("empty index")
        leaf_count = np.asarray(leaf_count_l, np.int32)
        index = BSPIndex.from_numpy(
            dict(dim=np.asarray(dim_l, np.int32),
                 mid=np.asarray(mid_l, np.float32),
                 low=np.asarray(low_l, np.int32),
                 high=np.asarray(high_l, np.int32),
                 leaf_start=np.asarray(leaf_start_l, np.int32),
                 leaf_count=leaf_count,
                 vectors=np.stack(vec_rows),
                 orig_row=np.arange(n, dtype=np.int32)),
            # the trie routes v >= center high (``add``), a deterministic
            # tie rule a point lookup CAN reproduce: ``locate`` descends
            # with >= on these trees (ties_high)
            [max_depth_seen, max(1, int(leaf_count.max())),
             int((np.asarray(dim_l) == -1).sum()), 1],
            device=self._device,
        )
        return index, records

    # --- remove ----------------------------------------------------------
    def remove(
        self,
        vector,
        distance: float,
        predicate: Optional[Callable] = None,
    ) -> int:
        """Remove matching records; returns the number removed.

        Emptied leaves are consolidated: single-child ancestor chains are
        orphaned and the first two-child ancestor drops the emptied side
        (MemoryVectorIndex.cs:463-486).
        """
        v = np.asarray(vector, dtype=np.float32)
        if self._entries and v.shape[0] != self._dim:
            raise ValueError("invalid vector size")
        if predicate is None:
            lim = float(distance) * float(distance)
            predicate = lambda r, q: float(
                np.sum((self._vec(r) - q) ** 2)
            ) <= lim
        removed = 0
        for leaf, path in self._walk(v, distance):
            bucket = self._buckets.get(leaf)
            if bucket is None:
                continue
            kept = [r for r in bucket if not predicate(r, v)]
            removed += len(bucket) - len(kept)
            if kept:
                self._buckets[leaf] = kept if len(kept) < len(bucket) \
                    else bucket
            else:
                del self._buckets[leaf]
                self._consolidate(leaf, path)
        self._size -= removed
        return removed

    def _consolidate(self, emptied: int, path: Sequence[int]) -> None:
        child = emptied
        for parent in reversed(path):
            low, high = self._entries[parent]
            if low == -1 or high == -1:
                # single-child chain node: orphan it and keep walking up
                self._entries[parent] = (-1, -1)
                child = parent
                continue
            self._entries[parent] = (-1, high) if low == child else (low, -1)
            return
        # emptied the root subtree entirely

    # --- introspection ---------------------------------------------------
    @property
    def index_hierarchy(self):
        """Yield ``(index, parent, centers, records)`` for every node —
        the debugging view of the trie (MemoryVectorIndex.cs:491-574)."""
        if not self._entries:
            return
        d = self._dim
        centers = np.zeros(d, dtype=np.float32)
        stack: list = [("visit", 0, -1, 0, 1.0)]
        while stack:
            action = stack.pop()
            if action[0] == "set":
                centers[action[1]] = action[2]
                continue
            _, node, parent, i, step = action
            low, high = self._entries[node]
            if low == -1 and high == -1:
                yield node, parent, centers.copy(), self._buckets.get(node)
                continue
            yield node, parent, centers.copy(), None
            c = float(centers[i])
            half = step / 2
            ni, nstep = (0, half) if i + 1 == d else (i + 1, step)
            stack.append(("set", i, c))
            if high != -1:
                stack.append(("visit", high, node, ni, nstep))
                stack.append(("set", i, c + half))
            if low != -1:
                stack.append(("visit", low, node, ni, nstep))
                stack.append(("set", i, c - half))

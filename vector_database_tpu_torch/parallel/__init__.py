"""Multi-device paths on ``torch.distributed`` (port of
``vector_database_tpu/parallel/``).

One process runs per device and every process runs the same code on its
own shard, calling collectives on a process group where the JAX package
runs one SPMD program under ``shard_map``:

| JAX (``vector_database_tpu/parallel/``) | here |
| --- | --- |
| ``Mesh(devices, ("data",))``, ``mesh.shape[axis]`` | ``DeviceMesh`` with ``mesh_dim_names``; ``axis_size(mesh, axis)``; the group is ``mesh.get_group(axis)`` |
| a ``shard_map(local, in_specs=P(axis...))`` body | the same local function, run by every rank on its own shard |
| ``lax.psum`` / ``pmax`` / ``pmin`` | ``dist.all_reduce(op=SUM/MAX/MIN, group=...)`` (``mesh.psum``) |
| ``lax.all_gather`` | ``dist.all_gather(list, t, group=...)`` (``mesh.all_gather``): the list form, which Gloo and NCCL both take |
| ``lax.axis_index(axis)`` | ``mesh.get_local_rank(axis)`` (``axis_rank``) |
| an array with a leading ``[P]`` shard dim, ``NamedSharding(P(axis))`` | each rank holds its own shard; replicated outputs (node tables, merged top-k) are identical on every rank |
| ``jax.distributed.initialize``, ``process_index``, ``process_allgather`` | ``dist.init_process_group`` from torchrun's environment; ``dist.get_rank()``; an ``all_gather`` over the world |
| ``lru_cache``d ``jit(shard_map(...))`` programs, ``interpret=``, ``check_vma``, ``pcast`` | gone; on CPU tensors the kernels' plain versions run, as everywhere in the port |

Every public function here is a collective over its mesh (or, for the
multislice entry points, the world): every rank calls it with the same
arguments, and every branch that decides whether a collective runs reads
values that are the same on every rank. NCCL ranks run on
``cuda:LOCAL_RANK``; a Gloo mesh on the host is built only on request
(``device_type="cpu"``).

- **build**: ``build_index_sharded``, one global tree over row-sharded
  data (the port's ``ops/sorted_build.py`` with a process group);
  ``to_bsp`` gathers it into one ``BSPIndex``.
- **query**: ``search_sharded``/``knn_sharded`` split a query batch over
  the ranks; ``build_forest``/``forest_knn`` one tree per rank with an
  all-gather top-k merge (``merge_topk``); ``search_global``/
  ``knn_global`` on the sharded tree.
- **serve**: ``pack_database_sharded`` + ``sharded_scan_knn``: each rank
  packs and scans its block with the port's scan kernel; the ``[Q, k]``
  lists merge in one all-gather. ``PackedServer`` takes such a pack.
- **multi-process / multi-slice**: ``init_distributed``, virtual slices of
  ranks (``slice_groups``, ``make_slice_meshes``) and the cross-slice
  index (rows partitioned across slices; only ``[Q, k]``-sized merges
  cross them).
"""

from vector_database_tpu_torch.parallel.mesh import (
    make_mesh,
    make_mesh_2d,
    shard_rows,
)
from vector_database_tpu_torch.parallel.query import search_sharded, knn_sharded
from vector_database_tpu_torch.parallel.global_tree import (
    ShardedBSPIndex,
    ShardedRows,
    build_index_sharded,
    knn_global,
    make_sharded_rows,
    search_global,
    to_bsp,
)
from vector_database_tpu_torch.parallel.forest import (
    ShardedForest,
    build_forest,
    forest_knn,
    merge_topk,
)
from vector_database_tpu_torch.parallel.scan import (
    ShardedPackedDB,
    calibrate_probes_sharded,
    pack_database_sharded,
    sharded_scan_knn,
)
from vector_database_tpu_torch.parallel.multislice import (
    MultiSliceIndex,
    build_index_multislice,
    init_distributed,
    knn_multislice,
    make_slice_meshes,
    search_multislice,
    slice_groups,
)

__all__ = [
    "make_mesh",
    "make_mesh_2d",
    "shard_rows",
    "search_sharded",
    "knn_sharded",
    "ShardedBSPIndex",
    "ShardedRows",
    "build_index_sharded",
    "make_sharded_rows",
    "search_global",
    "knn_global",
    "to_bsp",
    "ShardedForest",
    "build_forest",
    "forest_knn",
    "merge_topk",
    "ShardedPackedDB",
    "calibrate_probes_sharded",
    "pack_database_sharded",
    "sharded_scan_knn",
    "MultiSliceIndex",
    "build_index_multislice",
    "init_distributed",
    "knn_multislice",
    "make_slice_meshes",
    "search_multislice",
    "slice_groups",
]

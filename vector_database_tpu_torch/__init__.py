"""vector_database_tpu_torch: the vector index engine on PyTorch and CUDA.

A port of ``vector_database_tpu`` (JAX, TPU) to PyTorch, with every
kernel written by hand in CUDA C++ for NVIDIA Hopper (``csrc/``). Public
names and signatures follow the JAX package, so a caller or a test finds
each counterpart by name. This package never imports JAX.

The ported slices are the main path and the int8 capacity path:

- ``build_index_fused``: the level-synchronous variance-split BSP build,
  which yields the leaf-major matrix (``builder.py``,
  ``ops/sorted_build.py``), and ``build_index``, the host-loop build
  (``ops/level.py``) with its streamed node blocks and its mesh forms
  (rows sharded, and the tensor-parallel ``dim_axis``);
- ``pack_database`` (bf16, int8 and int8f blocks) and the bucketed scan,
  full or pruned by block probes, with an exact f32 rerank
  (``ops/packed_knn.py`` over the CUDA kernels in ``ops/bucket_scan.py``
  and, for pure-int8 packs, the exact integer scan in
  ``ops/bucket_scan_i8.py``), behind ``PackedServer`` (``serving.py``);
- the exact oracle (``ops/exact.py``) and the exact radius ``search`` /
  ``knn`` through the tree (``search.py``);
- the A/B probe of the scan's time split
  (``benchmarks/probe_kernel_ab.py``, its own CUDA kernel);
- the mutable collections: ``DynamicIndex`` (``dynamic.py``: main
  segment + delta, tombstones served over a packed scan through
  ``PackedDB.mask_rows``, compaction) and ``DocumentStore``
  (``document_store.py``: documents, texts, per-document indexes and a
  store-wide serving index), over the blocked streaming scan
  ``scan_knn`` (``ops/scan_knn.py``);
- ``locate``, the exact-match point lookup by single-branch descent, and
  the reference's ``tie_break="mean_id"`` build;
- out-of-core serving (``ChunkedIndex`` over ``NativeVectorStore``) and
  the in-memory models;
- the multi-device layer, ``parallel`` (one process per device on
  ``torch.distributed``): the sharded global-tree build, the query-sharded
  search, the forest, sharded scan serving (``PackedServer`` takes a
  ``ShardedPackedDB``) and the multi-slice index.

Tensors stay on the device they are given (or the ``device=`` argument);
host data with no ``device=`` goes to the card (``cuda``), as the JAX
package puts it on its default device (``utils/device.py``). On CPU
tensors each kernel's plain torch version runs instead.
"""

from vector_database_tpu_torch.builder import build_index, build_index_fused
from vector_database_tpu_torch.document_store import DocumentStore
from vector_database_tpu_torch.dynamic import DynamicIndex
from vector_database_tpu_torch.models.boolmatrix import BoolMatrixIndex
from vector_database_tpu_torch.models.bsp import BSPIndex
from vector_database_tpu_torch.models.memindex import MemoryVectorIndex
from vector_database_tpu_torch.out_of_core import ChunkedIndex
from vector_database_tpu_torch.ops.exact import (
    exact_ball,
    exact_knn,
    exact_mips,
    normalize_rows,
)
from vector_database_tpu_torch.ops.packed_knn import (
    PackedDB,
    calibrate_probes,
    pack_database,
    pallas_scan_knn,
    pallas_scan_knn_packed,
    pallas_scan_knn_packed_rt,
)
from vector_database_tpu_torch.ops.scan_knn import scan_knn
from vector_database_tpu_torch.runtime.native_store import NativeVectorStore
from vector_database_tpu_torch.search import (
    SearchResult,
    calibrate_radius,
    knn,
    locate,
    search,
)
from vector_database_tpu_torch.serving import PackedServer

__version__ = "0.1.0"

__all__ = [
    "BSPIndex",
    "BoolMatrixIndex",
    "ChunkedIndex",
    "DocumentStore",
    "DynamicIndex",
    "MemoryVectorIndex",
    "NativeVectorStore",
    "PackedDB",
    "PackedServer",
    "SearchResult",
    "build_index",
    "build_index_fused",
    "calibrate_probes",
    "calibrate_radius",
    "exact_ball",
    "exact_knn",
    "exact_mips",
    "knn",
    "locate",
    "normalize_rows",
    "pack_database",
    "pallas_scan_knn",
    "pallas_scan_knn_packed",
    "pallas_scan_knn_packed_rt",
    "scan_knn",
    "search",
]

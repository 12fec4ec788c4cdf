"""Hand-written CUDA kernels of the port, each beside its plain PyTorch twin.

| module          | CUDA source          | replaces (JAX package)                 |
| detect.py       | csrc/detect.cu       | ops/pallas_detect.py::_detect_kernel   |
|                 |                      | (plain, adaptive, consolidating)       |
| gather_cols.py  | csrc/gather_cols.cu  | ops/pallas_select.py::_cols_kernel     |
| gather_rows.py  | csrc/gather_rows.cu  | ops/pallas_select.py::_rows_kernel     |
| merge.py        | csrc/merge2d.cu      | ops/pallas_merge.py::_merge_kernel     |
|                 |                      | and ::_merge_tables_kernel             |
| merge.py        | csrc/merge3d.cu      | ops/pallas_merge.py::_merge_kernel_3d  |
| merge.py        | csrc/merge4d.cu      | ops/pallas_merge.py::_merge_kernel_4d  |
| cardinality.py  | csrc/cardinality.cu  | filters/cphd.py::cardinality_predict_  |
|                 |                      | batch (XLA max, exp, dot and log; no   |
|                 |                      | Pallas)                                |

Shared headers: ``csrc/bulk_copy.cuh`` (the TMA bulk copy of a slab into
shared memory on an mbarrier, used by both gathers, detect's staged
variants and the cardinality prediction) and ``csrc/wrap.cuh``
(the bearing wrap of detect.cu and merge2d.cu).

A wrapper runs its twin for a CPU tensor and launches its kernel for a CUDA
tensor (or raises); there is no fallback from one to the other. Launches
are counted in ``build.launch_counts``, each variant under its own name
(the gathers: ``gather_cols`` / ``gather_rows`` with the slab staged in
shared memory, ``gather_cols_ldg`` / ``gather_rows_ldg`` above
``build.GATHER_SMEM_BUDGET``), each inside its span ``kernel.<name>``
(``runtime/profiling.py``).
"""

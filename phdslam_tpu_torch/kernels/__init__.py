"""Hand-written CUDA kernels of the port, each beside its plain PyTorch twin.

| module          | CUDA source          | replaces (JAX package)                 |
| detect.py       | csrc/detect.cu       | ops/pallas_detect.py::_detect_kernel   |
| gather_cols.py  | csrc/gather_cols.cu  | ops/pallas_select.py::_cols_kernel     |
| merge.py        | csrc/merge2d.cu      | ops/pallas_merge.py::_merge_kernel     |
| merge.py        | csrc/merge4d.cu      | ops/pallas_merge.py::_merge_kernel_4d  |

A wrapper runs its twin for a CPU tensor and launches its kernel for a CUDA
tensor (or raises); there is no fallback from one to the other. Launches
are counted in ``build.launch_counts``.
"""

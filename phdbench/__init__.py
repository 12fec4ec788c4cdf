"""The benchmark of phdslam_tpu_torch (see run.py and BENCHMARK.json)."""

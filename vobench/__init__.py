"""The benchmark of vo_tpu_torch on one NVIDIA H100 (`python3 vobench/run.py`)."""

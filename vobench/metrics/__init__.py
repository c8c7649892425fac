"""Per-layer metrics: `<name>.py` holds the reader `read(run)` of the
metric `<name>` of BENCHMARK.json; `work.py` the kernels' work and the
card's peaks."""

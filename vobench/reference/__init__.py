"""The plain reference that decides a run's `correct`.

A frozen copy of the plain PyTorch code of the measured pipelines (the
port's `ops`, `geometry`, `frontend` and `models/vo.py`, copied under the
same module names so that the copied callers stay as they were). The four
modules that wrap hand-written CUDA kernels (`ops/lk_cuda.py`,
`ops/blur_cuda.py`, `ops/crop_cuda.py`, `ops/rowconv_cuda.py`) hold only
their plain versions here, which run on any device. Nothing here imports
the measured program, JAX, or any module outside this package.
"""

from __future__ import annotations

import torch

# Geometry (essential matrices, depths) needs true fp32 products.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device the reference runs on: ``cuda`` unless told otherwise."""
    return torch.device("cuda" if device is None else device)

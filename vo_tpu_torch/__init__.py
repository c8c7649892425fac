"""vo_tpu_torch — the monocular VO pipeline in PyTorch, for one NVIDIA H100.

A port of ``vo_tpu`` (JAX) that keeps its layout and names: ``ops`` (pyramid,
LK, FAST, NMS, Harris, BRIEF, Hamming), ``geometry`` (5-point RANSAC, pose,
depths, scale), ``frontend`` (ORB), ``models`` (``TrackingVO``), ``runtime``
(presets), ``data`` (synthetic sequences) and ``utils`` (ATE/RPE).

The two kernels that ``vo_tpu`` wrote in Pallas for the TPU on this path are
hand-written CUDA C++ under ``csrc/``, built with ``nvcc`` at first use
(``_build.py``): the LK level solve (``ops/lk_cuda.py``) and the separable
blur (``ops/blur_cuda.py``). Each wrapper runs its plain PyTorch version on a
CPU tensor and its kernel on a CUDA tensor.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# Geometry (essential matrices, depths) needs true fp32 products, as
# vo_tpu/__init__.py forces "highest" matmul precision in JAX.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.
    Raises when a CUDA device is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vo_tpu_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU"
        )
    return dev

"""Check and time the SIFT detect's window crop (B3) and gradient (B4)
kernels on one CUDA card, without the pipeline runs of chip_smoke.py.

    python3 scripts/time_sift_kernels.py

Builds the four kernels (printing each compiled kernel's registers, stack
frame and spills), captures the B3 and B4 calls of one tracking_sift detect
of frame 0 at KITTI shape (376x1241), and runs chip_smoke.py's `check_crop`
and `check_rowconv` on them: bit for bit against the plain versions, then
each entry point's device time beside its bound, plain version and one
PyTorch call. Prints the card's name and power limit first and one JSON
line of the two kernels' results last. To compare kernel variants, run it
from one tree per variant within one call.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_sift_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vo_tpu_torch import _build
    from vo_tpu_torch.data.synthetic import SyntheticSequence

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    logs = _build.build(["lk_refine", "separable_blur", "row_conv",
                         "crop_windows"])
    cs._log(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name in ("crop_windows", "row_conv"):
        for line in cs.ptxas_summary(logs.get(name, "")):
            cs._log(f"  {name}: {line}")
    device = torch.device("cuda")
    seq = cs._Staged(SyntheticSequence.generate(
        n_frames=cs.N_FRAMES, shape=cs.SHAPE, n_points=4000,
        yaw_amplitude=0.3, n_turns=2.0), device)
    calls = cs.capture_sift(seq, device)
    kernels = [cs.check_crop(calls["crop_windows_pair"], device),
               cs.check_rowconv(calls["conv_rows_cols"], device)]
    print(json.dumps({"kernels": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

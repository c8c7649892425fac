"""vo_tpu's `compare` report (its ORB canvas path, one level, against the
numpy oracle of tests/oracles.py) on the frame that chip_smoke.py hands the
port's `compare`: frame 0 of its 60-frame KITTI-shape synthetic sequence
(376x1241, bench.py's real-motion parameters), rounded to 8 bits and
written as a PNG. chip_smoke.py holds the port's report to these figures.

    JAX_PLATFORMS=cpu python3 scripts/eval_ref_compare.py [--full]

Prints vo_tpu's report as one JSON line. Needs JAX (runs on the CPU) and
the port's package for its PNG encoder and frame.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vo_tpu.runtime.compare import run_compare  # noqa: E402
from vo_tpu_torch.data.kitti import encode_png  # noqa: E402
from vo_tpu_torch.runtime.compare import synthetic_frame  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as d:
        png = os.path.join(d, "000000.png")
        with open(png, "wb") as f:
            f.write(encode_png(synthetic_frame().astype("uint8")))
        report = run_compare(png, None, args.full)
    report["image"] = "chip_smoke frame 0"
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

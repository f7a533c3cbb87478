#!/usr/bin/env python3
"""``chip_smoke.py`` phase 4's install on the card, alone: the six ops
calibrated with phase 4's arguments (``CALIBRATE_ARGS``, the Halton sample
counts of ``CALIBRATE_SAMPLES``) through ``repro_torch.launch.calibrate``,
and phase 4's ``[install]`` lines: per op the model selected, and per model
family its estimated and ideal mean speedup over the default knob, its
normalised RMSE and its evaluation time.

``--src`` names the ``src`` directory whose ``repro_torch`` installs, so
one call can compare two checkouts' labels (``core/timing.py``) on the
same card:

    python3 scripts/torch_install_report.py --src build/parent/src \\
        --label parent
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--label", default="this checkout")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import CALIBRATE_ARGS, CALIBRATE_SAMPLES
    from repro_torch.kernels import ops
    from repro_torch.launch import calibrate

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="install_report_") as tmp:
        for op in ops.HOPPER_OPS:
            calibrate.main(["--out", tmp, "--ops", op, "--samples",
                            str(CALIBRATE_SAMPLES[op]), *CALIBRATE_ARGS])
        reports = json.loads((Path(tmp) / "calibration_report.json")
                             .read_text())
    for report in reports:
        print(f"[install] [{card}] {args.label}: {report['op']} best "
              f"{report['best_model']}, {report['n_samples']} dims x "
              f"{report['n_knobs']} knobs, gather "
              f"{report['gather_seconds']:.1f} s", flush=True)
        for row in report["models"]:
            print(f"[install:{report['op']}] [{card}] {args.label}: "
                  f"{row['name']}: estimated mean speedup "
                  f"{row['estimated_mean_speedup']:.3f}, ideal "
                  f"{row['ideal_mean_speedup']:.3f}, normalized rmse "
                  f"{row['normalized_rmse']:.3f}, eval "
                  f"{row['eval_time_us']:.1f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

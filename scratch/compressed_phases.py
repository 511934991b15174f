"""chip_smoke.py's compressed phases alone (16: the 16x16 lattice at chi=32
in float64 and float32 with the SVD and QR kernels' rows; 28: the mixed
complex lattice), from any checkout, on the card:

    python scratch/compressed_phases.py [dir]

``dir`` (default: this checkout) is the checkout whose package and
``chip_smoke.py`` run.
"""

import json
import os
import sys

root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, root)
os.chdir(root)

import chip_smoke  # noqa: E402
from cotengra_tpu_torch import resolve_device  # noqa: E402

dev = resolve_device("cuda")
chip_smoke.phase_device()
chip_smoke.phase_build()
rows = chip_smoke.phase_compressed(dev)
chip_smoke.phase_mixed_compressed(dev)
if isinstance(rows, tuple):
    svd_rows, qr_rows = rows
    out = {"qr_core": {str(k): v for k, v in qr_rows.items()}}
else:
    svd_rows = rows
    out = {}
out["svd_core"] = {str(k): v for k, v in svd_rows.items()}
print(json.dumps(out, default=str), flush=True)

#!/usr/bin/env python3
"""Device time of the pairwise-IoU CUDA kernel by outputs per thread.

    python3 tools/iou_per_thread_sweep.py

Needs one NVIDIA GPU.  Builds the kernel, then reads its device time per
launch (``torch.profiler``, ``chip_smoke.kernel_device_ms``) at 1, 2, 4,
8 and 16 outputs per thread on the packed batches of the first tab2 and
tab3 serving flushes (the traces and requests of ``chip_smoke.py``) and
on one 1000-box image, beside the number ``ops.per_thread`` picks.  The
sweep is what ``ops.BLOCKS_PER_SM``'s rule (one output per thread while
the grid fits in one wave of resident blocks) was chosen from.  Prints
one JSON object.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("iou_per_thread_sweep.py: no CUDA device available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import native
    from repro_torch.kernels.iou_matrix import ops

    dev = torch.device("cuda", 0)
    batches = {label: cs.serve_traffic(label)[3]
               for label in cs.SERVE_PASSES}
    batches["1000x1000"] = [cs.rand_boxes(np.random.default_rng(2),
                                          (1000,))]
    sms = native.sm_count(dev)
    out = {"device": torch.cuda.get_device_name(0), "sms": sms}
    for label, boxes in batches.items():
        total = sum(len(b) ** 2 for b in boxes)
        out[label] = {
            "outputs": total,
            "picked": ops.per_thread(total, sms),
            "device_ms_by_per_thread": {
                k: cs.kernel_device_ms(boxes, dev, per_thread=k)[0]
                for k in (1, 2, 4, 8, 16)}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

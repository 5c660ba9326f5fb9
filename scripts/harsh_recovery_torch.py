#!/usr/bin/env python3
"""Harsh-envelope recovery study of the PyTorch/CUDA port, on the card.

Renders (or reuses) a harsh thermal variant of one agent's 6-DoF dataset and
replays it solo with the health monitor off and on; writes the reference's
JSON (settings, results, the gates ``monitor_reinit_fired`` and
``recovery_bounds_error``) to ``--out``
(``x_multi_agent_torch/utils/harsh_recovery.py``).

Usage (flags as the reference's ``scripts/harsh_recovery.py``):

    XMAT_DATASET_DIR=/path/to/datasets python3 scripts/harsh_recovery_torch.py \\
        --presets harsh --cheap-imu --outage 250:350 [--duration 60] [--frames 600]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from x_multi_agent_torch.utils import harsh_recovery  # noqa: E402

if __name__ == "__main__":
    # the filter's algebra runs in full fp32 (the facade raises otherwise)
    torch.backends.cuda.matmul.allow_tf32 = False
    harsh_recovery.main()

#!/usr/bin/env python3
"""Solo-replay stage diagnostics of the PyTorch/CUDA port, on the card.

Replays one agent of the thermal 6-DoF dataset solo with single stages
switched off and prints the reference's one-line JSON summary
(``x_multi_agent_torch/utils/diag_solo.py``).

Usage (flags as the reference's ``scripts/diag_solo.py``):

    XMAT_DATASET_DIR=/path/to/datasets python3 scripts/diag_solo_torch.py \\
        [--no-oc] [--no-spatial] [--no-photo] [--no-health] [--clean-thermal] [--degraded] \\
        [--sigma-img-px 2.0] [--imu-scale 1.0] [--frames 250] [--agent 0] [--tag diag]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from x_multi_agent_torch.utils import diag_solo  # noqa: E402

if __name__ == "__main__":
    # the filter's algebra runs in full fp32 (the facade raises otherwise)
    torch.backends.cuda.matmul.allow_tf32 = False
    diag_solo.main()

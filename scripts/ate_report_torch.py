#!/usr/bin/env python3
"""Dataset-replay ATE report of the PyTorch/CUDA port, on the card.

Renders (or reuses) the thermal 6-DoF dataset of N agents, replays every
agent solo and then all of them collaboratively with REQUEST_COMM
exchanges through the port's ``VIO`` facade, and reports aligned ATE, NEES
against the [1.5, 4.5] band, the degraded agent's collaborative gain and
bytes against a full broadcast (``x_multi_agent_torch/utils/ate_report.py``).

Usage (flags as the reference's ``scripts/ate_report.py``):

    XMAT_DATASET_DIR=/path/to/datasets python3 scripts/ate_report_torch.py \\
        --vocab random [--duration 60] [--agents 4] [--out report.json]

The dataset, the solo caches and the replay checkpoints live under
``XMAT_DATASET_DIR`` (default: ``xmat_dataset`` in the temp directory). A
run that is cut resumes from its checkpoint when started again with the
same flags. Exits 2 when a gate fails.
"""
import faulthandler
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from x_multi_agent_torch.utils import ate_report  # noqa: E402

if __name__ == "__main__":
    faulthandler.enable()
    # periodic stack dump, so a hang shows where it is
    faulthandler.dump_traceback_later(600, repeat=True, file=sys.stderr)
    # the filter's algebra runs in full fp32 (the facade raises otherwise)
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.exit(ate_report.main())

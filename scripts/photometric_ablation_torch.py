#!/usr/bin/env python3
"""Photometric ablation of the PyTorch/CUDA port, on the card.

Replays agent 0 of a vignette-dominated thermal dataset solo with the online
photometric correction off, global and spatial; prints one JSON line per
mode and the verdict ``spatial_improves_ate``
(``x_multi_agent_torch/utils/photometric_ablation.py``).

Usage (flags as the reference's ``scripts/photometric_ablation.py``):

    XMAT_DATASET_DIR=/path/to/datasets python3 scripts/photometric_ablation_torch.py \\
        [--frames 250] [--duration 30] [--vignette 0.30] [--modes off,global,spatial]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from x_multi_agent_torch.utils import photometric_ablation  # noqa: E402

if __name__ == "__main__":
    # the filter's algebra runs in full fp32 (the facade raises otherwise)
    torch.backends.cuda.matmul.allow_tf32 = False
    photometric_ablation.main()

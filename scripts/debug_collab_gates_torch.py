#!/usr/bin/env python3
"""Gate bisect of the port's request-response fusion, on the card.

Replays agents 0 and 2 of the thermal 6-DoF dataset for ``--frames``
frames, then prints the kNN count, the matches applied under each gate
variant of ``fuse_with_peer_desc`` and the receive of the served keyframe
(``x_multi_agent_torch/utils/debug_collab_gates.py``; ``KF_PROBE=1`` adds
the keyframe probe).

Usage (flags as the reference's ``scripts/debug_collab_gates.py``):

    XMAT_DATASET_DIR=/path/to/datasets python3 scripts/debug_collab_gates_torch.py \\
        --frames 120 --vocab random
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from x_multi_agent_torch.utils import debug_collab_gates  # noqa: E402

if __name__ == "__main__":
    # the filter's algebra runs in full fp32 (the facade raises otherwise)
    torch.backends.cuda.matmul.allow_tf32 = False
    debug_collab_gates.main()

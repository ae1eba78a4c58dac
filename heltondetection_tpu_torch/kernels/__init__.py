"""Python wrappers of the port's hand-written CUDA kernels (sources in
``csrc/``, built on first use by :mod:`.build`).

``launch_counts`` holds one integer per kernel. A wrapper adds one where it
launches its kernel and nowhere else, so a caller can reset the counts, run
a path and show which kernels that path went through. It is the port's one
count of launches: the tracer (``utils/trace.py``) reports it as the
``kernel.<name>`` counters of each ``take()``.
"""

from __future__ import annotations

from typing import Dict

KERNELS = ("nms_fixpoint", "nms_mask", "iou_matrix")

launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0

"""The FasterRCNN assigners' share of their roofline: the least time any
implementation needs for the cell's batch (the valid pairs' IoU operations
at the float32 peak, or the boxes read once and one assignment written per
anchor or proposal at the HBM peak, whichever is larger) over the CUDA-event
time of the harness's calls of ``assign_rpn_targets`` and
``assign_box_targets``. Nothing where the cell has no such assigners."""


def read(record):
    if record.get("kind") != "train":
        return None
    return record.get("assign_roofline_pct")

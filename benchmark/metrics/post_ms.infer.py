"""CUDA-event ms of the harness's own call of what follows the network
(candidate selection, decode and NMS; FasterRCNN's proposals, RoIAlign,
box head and postprocess) on the network's outputs for one batch."""


def read(record):
    if record.get("kind") != "infer":
        return None
    return record["spans_ms"]["post"]

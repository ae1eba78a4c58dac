"""CUDA-event ms of the harness's own call of the network (backbone, neck,
dense head) on one batch of the cell."""


def read(record):
    if record.get("kind") != "infer":
        return None
    return record["spans_ms"]["trunk"]

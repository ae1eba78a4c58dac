"""CUDA-event ms of the harness's own call of the optimizer step (clip,
AdamW, schedule) and the EMA update after a backward."""


def read(record):
    if record.get("kind") != "train":
        return None
    return record["spans_ms"]["optim"]

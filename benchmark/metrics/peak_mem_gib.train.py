"""``max_memory_allocated`` over the train window, after
``reset_peak_memory_stats`` at its start, in GiB."""


def read(record):
    if record.get("kind") != "train":
        return None
    return record["peak_bytes"] / 2 ** 30

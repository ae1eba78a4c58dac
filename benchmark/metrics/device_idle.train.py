"""Share of the profiled slice of train steps (about a second of them) in
which no operation ran on the device (the union of kernel, copy and fill
intervals)."""


def read(record):
    if record.get("kind") != "train":
        return None
    return record["slice"].idle_pct

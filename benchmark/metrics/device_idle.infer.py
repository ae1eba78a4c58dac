"""Share of the profiled slice of the eval window in which no operation
ran on the device (the union of kernel, copy and fill intervals)."""


def read(record):
    if record.get("kind") != "infer":
        return None
    return record["slice"].idle_pct

"""Settings of the benchmark's own tests (``python -m pytest benchmark/tests``):
the ``card`` marker, and the fixtures that decide inside a test whether
there is a card and that cut a cell to a size the CPU runs in seconds."""

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the control runs on the card")
    return torch.device("cuda", 0)


def shrink(cell, dtype="float32"):
    """``cell`` cut to a CPU-sized copy: width 0.125 for YOLOv5, 128² frames,
    batches of 2, a ring of 3, fewer proposals and samples for FasterRCNN,
    the program in ``dtype``."""
    cfg = copy.deepcopy(cell.config)
    cfg.update(img_size=128, dtype=dtype)
    if cfg["family"] == "yolov5":
        cfg["width_multiple"] = 0.125
    else:
        cfg["rpn"].update(pre_nms_topk=200, post_nms_topk=100, batch=64)
        cfg["box"]["batch"] = 64
    cfg["eval"]["batch"] = cfg["train"]["batch"] = 2
    mix = copy.deepcopy(cell.traffic)
    mix.update(ring=3, check_batches=2)
    for s in mix["source_shapes"]:
        s[0] //= 5
        s[1] //= 5
    mix["object_sizes"] = [[0.5, 4, 16], [0.5, 16, 60]]
    cell.config, cell.traffic = cfg, mix
    return cell


@pytest.fixture
def tiny():
    """``tiny(workload)``: the cell of BENCHMARK.json, shrunk; or
    ``tiny(config=…, traffic=…)``, a pairing that is no cell (no limits)."""
    from benchmark.harness import cell as cells

    def make(workload=None, dtype="float32", config=None, traffic=None):
        if workload is not None:
            return shrink(cells.load(workload), dtype)
        root = os.path.join(ROOT, "benchmark")
        with open(os.path.join(root, "configs", config + ".json")) as f:
            cfg = json.load(f)
        with open(os.path.join(root, "traffic", traffic + ".json")) as f:
            mix = json.load(f)
        return shrink(cells.Cell(f"{config}.{traffic}", {}, cfg, mix, {},
                                 [], []), dtype)
    return make

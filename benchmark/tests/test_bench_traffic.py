"""The traffic mixes are functions of the seed."""

import torch

from benchmark.harness import frames

CPU = torch.device("cpu")


def test_eval_ring_is_deterministic_by_seed(tiny):
    c = tiny("yolov5s-coco640-eval-b32")
    a = frames.eval_ring(c.traffic, c.config, 2 ** 31 + 5, 2, CPU, pin=False)
    b = frames.eval_ring(c.traffic, c.config, 2 ** 31 + 5, 2, CPU, pin=False)
    d = frames.eval_ring(c.traffic, c.config, 2 ** 31 + 6, 2, CPU, pin=False)
    assert len(a) == c.traffic["ring"]
    for x, y in zip(a, b):
        assert torch.equal(x["image"], y["image"])
        assert x["orig_hw"] == y["orig_hw"] and x["pad_y"] == y["pad_y"]
    assert not all(torch.equal(x["image"], y["image"]) for x, y in zip(a, d))
    assert a[0]["image"].shape == (2, 128, 128, 3)


def test_train_ring_is_deterministic_by_seed(tiny):
    c = tiny(config="faster_rcnn_pafpn_decoupled_coco_832",
             traffic="coco-train-mosaic")
    a = frames.train_ring(c.traffic, c.config, 77, 2, CPU)
    b = frames.train_ring(c.traffic, c.config, 77, 2, CPU)
    d = frames.train_ring(c.traffic, c.config, 78, 2, CPU)
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert not all(torch.equal(x["gt_xyxy"], y["gt_xyxy"])
                   for x, y in zip(a, d))
    m = a[0]["gt_mask"]
    assert m.shape == (2, c.config["train"]["max_boxes"]) and m.any()
    box = a[0]["gt_xyxy"][m]
    assert (box[:, 2:] > box[:, :2]).all() and (box >= 0).all()
    assert (box <= c.config["img_size"]).all()

"""Parity of the port's train data path (heltondetection_tpu_torch/data:
readers.py, augment.py, loader.py) with the JAX package's on the CPU.

The port has no OpenCV in its train pipeline; the reference resizes,
converts colour and warps with cv2. Tolerances:

- RGB↔HSV: equal to cv2's uint8 conversions exactly, so the HSV jitter
  equals the reference's exactly on the same image and draws;
- the affine warp: within 1 grey level of ``cv2.warpAffine``;
- ``TrainPipeline.sample``: the same draws give the same boxes (float32,
  to 1e-4 px), classes and masks exactly; pixels within 1 grey level
  without HSV (torch's bilinear resize and warp against cv2's fixed
  point); with HSV the 99th percentile within 2, the mean under 0.5 and
  none beyond 16: a ±1 input moves the hue of a grey-ish pixel by many
  degrees, and the lookup tables scale saturation and value by up to
  1.7;
- ``TrainLoader``/``EvalLoader``: the same permutation and batches, the
  same numbers as the pipelines; every wait bounded.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import cv2

from heltondetection_tpu.data import augment as JA
from heltondetection_tpu.data import loader as JL
from heltondetection_tpu.data import readers as JR

from heltondetection_tpu_torch.data import augment as PA
from heltondetection_tpu_torch.data import loader as PL
from heltondetection_tpu_torch.data import readers as PR

from synth_data import build_coco_dataset


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Frames:
    """An in-memory reader of mixed-size frames (filled rectangles on
    noise), one of them with a crowd box."""

    sizes = [(75, 100), (96, 128), (144, 256), (128, 96), (60, 60)]

    def __init__(self, n=8, seed=0, num_classes=5):
        rng = np.random.default_rng(seed)
        self.num_classes = num_classes
        self.items = []
        for i in range(n):
            h, w = self.sizes[i % len(self.sizes)]
            img = rng.integers(60, 200, (h, w, 3)).astype(np.uint8)
            k = int(rng.integers(1, 5))
            wh = rng.uniform(0.15, 0.5, (k, 2)) * [w, h]
            xy = rng.uniform(0, 1, (k, 2)) * ([w, h] - wh)
            boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
            cls = rng.integers(0, num_classes, k).astype(np.int32)
            for (x1, y1, x2, y2), c in zip(boxes.astype(int), cls):
                img[y1:y2, x1:x2] = (40 * c + 30, 200 - 30 * c, 90)
            crowd = np.zeros(k, np.int32)
            if i == 2:
                crowd[0] = 1
            self.items.append({"image": img, "boxes": boxes, "classes": cls,
                               "iscrowd": crowd, "img_id": i,
                               "file": f"{i}.png"})

    def __len__(self):
        return len(self.items)

    def load(self, i):
        return self.items[i]


def test_hsv_conversions_equal_cv2():
    """RGB→HSV equals cv2 exactly on 320,000 random pixels, the greys and
    the primaries. HSV→RGB equals cv2's scalar conversion exactly over the
    whole HSV grid of every fifth hue; cv2's vectorized path, which it
    takes for wide rows, rounds differently: within 1 grey level. So the
    jitter is within 1 of the reference's."""
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (500, 640, 3)).astype(np.uint8)
    rgb[0, :256] = np.arange(256)[:, None]                  # greys
    rgb[1, :6] = [[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0],
                  [0, 255, 255], [255, 0, 255]]
    np.testing.assert_array_equal(PA.rgb_to_hsv(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    h, s, v = np.meshgrid(np.arange(0, 180, 5), np.arange(256),
                          np.arange(256), indexing="ij")
    hsv = np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, 1, 3)
    np.testing.assert_array_equal(PA.hsv_to_rgb(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    wide = hsv.reshape(-1, 256, 3)
    assert np.abs(PA.hsv_to_rgb(wide).astype(int) -
                  cv2.cvtColor(wide, cv2.COLOR_HSV2RGB)).max() <= 1
    img = rgb[:200, :320].copy()
    for seed in range(3):
        got = PA.random_hsv(img, np.random.default_rng(seed))
        want = JA.random_hsv(img, np.random.default_rng(seed))
        assert np.abs(got.astype(int) - want).max() <= 1


def test_warp_affine_within_one_level_of_cv2():
    rng = np.random.default_rng(1)
    img = cv2.GaussianBlur(rng.integers(0, 256, (120, 160, 3)).astype(
        np.uint8), (0, 0), 1.0)
    for seed in range(4):
        m, _ = PA.affine_params(np.random.default_rng(seed), 160, 120,
                                degrees=15.0, translate=0.2, scale=0.5,
                                shear=5.0)
        want = cv2.warpAffine(img, m, (160, 120), borderValue=(114,) * 3)
        got = PA.warp_affine(img, m, 160, 120)
        assert np.abs(got.astype(int) - want).max() <= 1
    np.testing.assert_array_equal(
        PA.rotation_matrix_2d((80, 60), 7.5, 1.3),
        cv2.getRotationMatrix2D((80, 60), 7.5, 1.3))


PIPE_CASES = {
    # name: (TrainPipeline knobs, max pixel difference)
    "mosaic_affine": (dict(mosaic_p=1.0, hsv=False, flip_p=0.0), 1),
    "letterbox_hsv_flip": (dict(mosaic_p=0.0, hsv=True, flip_p=1.0), 16),
    "mixup": (dict(mosaic_p=0.5, hsv=True, flip_p=0.5, mixup_p=1.0,
                   max_boxes=6), 16),
    "defaults": (dict(), 16),
}


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_train_pipeline_sample_matches_reference(case):
    knobs, max_diff = PIPE_CASES[case]
    ds = Frames()
    jp = JA.TrainPipeline(ds, 96, seed=3, **knobs)
    pp = PA.TrainPipeline(ds, 96, seed=3, **knobs)
    diffs = []
    for epoch in (0, 1):
        for idx in range(len(ds)):
            want, got = jp.sample(idx, epoch), pp.sample(idx, epoch)
            np.testing.assert_array_equal(got["gt_mask"], want["gt_mask"])
            np.testing.assert_array_equal(got["gt_cls"], want["gt_cls"])
            np.testing.assert_allclose(got["gt_boxes"], want["gt_boxes"],
                                       atol=1e-4)
            assert got["image"].shape == want["image"].shape == (96, 96, 3)
            diffs.append(np.abs(got["image"].astype(int) - want["image"]))
    d = np.stack(diffs)
    assert d.max() <= max_diff and d.mean() < 0.5, (d.max(), d.mean())
    assert np.percentile(d, 99) <= 2


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """A COCO json with cv2-written PNGs, one crowd box and one ignored
    annotation added."""
    root = tmp_path_factory.mktemp("coco")
    ann, imgs = build_coco_dataset(str(root), n_images=6)
    with open(ann) as f:
        d = json.load(f)
    d["annotations"] += [
        {"id": 900, "image_id": 2, "category_id": 11,
         "bbox": [5.0, 6.0, 30.0, 20.0], "area": 600.0, "iscrowd": 1},
        {"id": 901, "image_id": 3, "category_id": 12,
         "bbox": [1.0, 2.0, 10.0, 10.0], "iscrowd": 0, "ignore": 1}]
    with open(ann, "w") as f:
        json.dump(d, f)
    return ann, imgs


class _Gts:
    def __init__(self):
        self.calls = []

    def add_gt(self, *a, **k):
        self.calls.append((a, k))


def test_coco_dataset_matches_reference(coco):
    jd, pd = JR.COCODataset(*coco), PR.COCODataset(*coco)
    assert len(pd) == len(jd) == 6
    assert pd.num_classes == jd.num_classes == 4
    assert pd.label_to_cat == jd.label_to_cat
    for i in range(len(jd)):
        assert pd.meta(i) == jd.meta(i)
        want, got = jd.load(i), pd.load(i)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k, v in JR.drop_ignore_boxes(want).items():
            np.testing.assert_array_equal(PR.drop_ignore_boxes(got)[k], v)
    gj, gp = _Gts(), _Gts()
    jd.gt_for_eval(gj)
    pd.gt_for_eval(gp)
    assert gp.calls == gj.calls
    cached = PR.CachedDataset(pd, max_bytes=96 * 128 * 3)
    assert cached.load(1) is cached.load(1) and cached.num_classes == 4
    assert cached.load(4) is not cached.load(4)        # past the budget


def test_train_loader_matches_reference():
    """The reference's (seed, epoch) permutation and drop-last batches; the
    port's batches are CPU tensors here, equal with 1 and 3 workers."""
    ds = Frames(n=10)
    knobs = dict(mosaic_p=0.5, max_boxes=8, seed=1)
    jl = JL.TrainLoader(JA.TrainPipeline(ds, 64, **knobs), 4, seed=5,
                        num_workers=2)
    runs = [PL.TrainLoader(PA.TrainPipeline(ds, 64, **knobs), 4, seed=5,
                           num_workers=w, device="cpu") for w in (1, 3)]
    assert runs[0].steps_per_epoch() == jl.steps_per_epoch() == 2
    for epoch in (0, 3):
        want = list(jl.epoch(epoch))
        got = [list(p.epoch(epoch)) for p in runs]
        assert len(want) == len(got[0]) == 2
        for w, g1, g3 in zip(want, *got):
            for k in PL.TrainLoader.KEYS:
                assert isinstance(g1[k], torch.Tensor)
                assert torch.equal(g1[k], g3[k]), k
            assert g1["image"].dtype == torch.uint8
            for k in ("gt_boxes", "gt_cls", "gt_mask"):
                np.testing.assert_allclose(g1[k].numpy(), w[k], atol=1e-4)
            d = np.abs(g1["image"].numpy().astype(int) - w["image"])
            assert d.max() <= 16 and np.percentile(d, 99) <= 2
    jl.close()


def test_eval_loader_matches_reference():
    """Letterboxed batches with the inverse's metadata; the short last
    batch padded with img_id None rows."""
    ds = Frames(n=5)
    want = list(JL.EvalLoader(JA.EvalPipeline(ds, 96), 2, num_workers=2))
    got = list(PL.EvalLoader(PA.EvalPipeline(ds, 96), 2, num_workers=2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("img_id", "scale", "pad_x", "pad_y", "orig_hw"):
            assert list(g[k]) == list(w[k]), k
        assert np.abs(g["image"].astype(int) - w["image"]).max() <= 1
    assert got[-1]["img_id"] == [4, None]


class _Slow:
    """A pipeline whose samples take a while, or raise."""

    def __init__(self, n=64, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def sample(self, idx, epoch=0):
        if idx == self.fail_at:
            raise RuntimeError(f"sample {idx} failed")
        time.sleep(0.01)
        z = np.zeros((2, 2, 3), np.uint8)
        return {"image": z, "gt_boxes": np.zeros((1, 4), np.float32),
                "gt_cls": np.zeros(1, np.int32),
                "gt_mask": np.zeros(1, bool)}


def test_loader_threads_end_and_errors_surface():
    """Abandoning an epoch after one batch stops its producer and workers;
    a sample that raises reaches the consumer as its own error."""
    before = threading.active_count()
    loader = PL.TrainLoader(_Slow(), 4, num_workers=4, device="cpu")
    batches = loader.epoch(0)
    next(batches)
    batches.close()
    deadline = time.monotonic() + 30.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    order = np.random.default_rng(np.random.SeedSequence([0, 0])
                                  ).permutation(64)
    bad = PL.TrainLoader(_Slow(fail_at=int(order[9])), 4, num_workers=4,
                         device="cpu")
    with pytest.raises(RuntimeError, match="failed"):
        list(bad.epoch(0))

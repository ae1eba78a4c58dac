"""Training every YOLOv5 config with the port on the CPU: the readers, the
anchor fit, the config check, the fused NMS route and a DOTA-shaped run
(heltondetection_tpu_torch/data/readers.py, data/autoanchor.py,
engine/runner.py, ops/nms.py).

Tolerances: none. The readers give the reference's boxes, classes,
``iscrowd``, image ids and ``DetEval`` ground truth exactly on the same
files; the anchor fit gives the reference's anchors and stats exactly for
the same labels and seed (both are host numpy in the same order).
"""

import dataclasses
import glob
import logging
import math
import os

import numpy as np
import pytest
import torch

from heltondetection_tpu.data import autoanchor as JAA
from heltondetection_tpu.data import readers as JR
from heltondetection_tpu.utils.cocoeval import DetEval as JDetEval

from heltondetection_tpu_torch.configs import base as p_base
from heltondetection_tpu_torch.data import autoanchor as PAA
from heltondetection_tpu_torch.data import readers as PR
from heltondetection_tpu_torch.data.augment import EvalPipeline
from heltondetection_tpu_torch.data.loader import EvalLoader
from heltondetection_tpu_torch.engine import runner
from heltondetection_tpu_torch.engine.evaluator import Evaluator
from heltondetection_tpu_torch.models import cspdarknet as p_csp
from heltondetection_tpu_torch.ops.nms import fixpoint_route
from heltondetection_tpu_torch.utils.cocoeval import DetEval

from synth_data import (build_coco_dataset, build_dota_dataset,
                        build_visdrone_dataset, build_voc_dataset,
                        build_yolo_dataset)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _readers(kind, root):
    """(port reader, reference reader) over the same synthetic files."""
    if kind == "yolo":
        imgs, labels = build_yolo_dataset(root, n_images=4, seed=3)
        names = [f"class{c}" for c in range(4)]
        return (PR.YOLODataset(imgs, labels, names),
                JR.YOLODataset(imgs, labels, names))
    if kind == "dota":
        imgs, labels, names = build_dota_dataset(root, n_images=3, seed=4)
        return (PR.DOTADataset(imgs, labels, names),
                JR.DOTADataset(imgs, labels, names))
    if kind == "visdrone":
        imgs, labels = build_visdrone_dataset(root, n_images=3, seed=5)
        return (PR.VisDroneDataset(imgs, labels),
                JR.VisDroneDataset(imgs, labels))
    ann_dir, imgs, split, names = build_voc_dataset(root, n_images=4, seed=6)
    ann = ann_dir if kind == "voc_dir" else split
    return PR.VOCDataset(ann, imgs, names), JR.VOCDataset(ann, imgs, names)


def _gts(det):
    return {k: [(tuple(b), c, a, i) for b, c, a, i in v]
            for k, v in det._gts.items()}


@pytest.mark.parametrize("kind", ["yolo", "dota", "visdrone", "voc_dir",
                                  "voc_split"])
def test_reader_matches_reference(kind, tmp_path):
    """Every sample and the eval ground truth, exactly."""
    port, ref = _readers(kind, str(tmp_path))
    assert len(port) == len(ref) > 0
    assert port.num_classes == ref.num_classes
    assert port.label_to_cat == ref.label_to_cat
    for i in range(len(ref)):
        p, r = port.load(i), ref.load(i)
        assert set(p) == set(r)
        for k in ("image", "boxes", "classes", "iscrowd"):
            assert p[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)
        assert p["img_id"] == r["img_id"] and isinstance(p["img_id"], str)
        assert p["file"] == r["file"]
    pd, rd = DetEval(port.num_classes), JDetEval(ref.num_classes)
    port.gt_for_eval(pd)
    ref.gt_for_eval(rd)
    assert _gts(pd) == _gts(rd) and pd._gts
    if kind == "visdrone":
        # image 0's ignored region (category 0) is an ignore box of every
        # class; "others" (category 11) too; training drops both
        rows = [g for (img, _), v in pd._gts.items() if img == "0000000"
                for g in v if g[3]]
        assert len(rows) == 2 * port.num_classes
        s = port.load(0)
        assert s["iscrowd"].sum() == 2 and (s["classes"] >= 0).all()
        kept = PR.drop_ignore_boxes(s)["classes"]
        assert len(kept) == len(s["classes"]) - 2
    if kind.startswith("voc"):
        assert port.load(0)["iscrowd"][-1] == 1      # the difficult object


def test_build_dataset_every_format(tmp_path):
    """``build_dataset`` gives a reader for each of the five formats, and
    ``cache_images`` wraps it."""
    root = str(tmp_path)
    coco = build_coco_dataset(os.path.join(root, "coco"), n_images=2)
    yolo = build_yolo_dataset(os.path.join(root, "yolo"), n_images=2)
    dota = build_dota_dataset(os.path.join(root, "dota"), n_images=2)
    vis = build_visdrone_dataset(os.path.join(root, "vis"), n_images=2)
    voc = build_voc_dataset(os.path.join(root, "voc"), n_images=2)
    cases = {
        "coco": (dict(train_ann=coco[0], train_imgs=coco[1]),
                 PR.COCODataset),
        "yolo": (dict(train_ann=yolo[1], train_imgs=yolo[0]),
                 PR.YOLODataset),
        "dota": (dict(train_ann=dota[1], train_imgs=dota[0],
                      class_names=dota[2]), PR.DOTADataset),
        "visdrone": (dict(train_ann=vis[1], train_imgs=vis[0]),
                     PR.VisDroneDataset),
        "voc": (dict(train_ann=voc[2], train_imgs=voc[1],
                     class_names=voc[3]), PR.VOCDataset),
    }
    for fmt, (kw, cls) in cases.items():
        dc = p_base.DataConfig(format=fmt, **kw)
        ds = runner.build_dataset(dc, "train")
        assert isinstance(ds, cls) and len(ds) == 2, fmt
        assert len(ds.load(1)["boxes"]) > 0
        cached = runner.build_dataset(
            dataclasses.replace(dc, cache_images=True), "train")
        assert isinstance(cached, PR.CachedDataset) and \
            cached.num_classes == ds.num_classes
    with pytest.raises(ValueError, match="unknown dataset format"):
        runner.build_dataset(p_base.DataConfig(format="kitti"))


CONFIG_DIR = os.path.join(os.path.dirname(runner.__file__), "..", "configs")
YOLO_CONFIGS = sorted(os.path.basename(p) for p in
                      glob.glob(os.path.join(CONFIG_DIR, "yolov5_*.py")))


@pytest.mark.parametrize("name", YOLO_CONFIGS)
def test_every_yolov5_config_trains_but_the_backbone_swap(name):
    """Every YOLOv5 config passes the train config check, the backbone
    swap too now that the registry's backbones train."""
    cfg = p_base.load_config(os.path.join(CONFIG_DIR, name))
    runner._check_train_config(cfg)
    assert cfg.data.format in ("coco", "yolo", "dota", "voc", "visdrone")


def test_fused_nms_route_by_size():
    """The fused route's kernel by N on an 80 GB H100's limits: nms_fixpoint
    up to 2400, nms_mask above it (N padded to 32 and to 64) up to the
    largest N whose (N, N) bitmask, N²/8 bytes, fits the card's memory
    (800,000 at 80 GB; past N = 16384 its scan keeps its words in shared
    memory), and a ValueError naming both limits beyond. The reference's
    XLA fixpoint takes any N; its (N, N) f32 matrix is 32 times larger per
    entry."""
    mask_max = math.isqrt(80 * 10**9 * 8) // 64 * 64
    assert mask_max == 800000
    for n, want in ((1, "nms_fixpoint"), (1024, "nms_fixpoint"),
                    (2369, "nms_fixpoint"), (2400, "nms_fixpoint"),
                    (2401, "nms_mask"), (4096, "nms_mask"),
                    (16383, "nms_mask"), (16384, "nms_mask"),
                    (16385, "nms_mask"), (16448, "nms_mask"),
                    (20000, "nms_mask"), (65536, "nms_mask"),
                    (799999, "nms_mask"), (800000, "nms_mask")):
        assert fixpoint_route(n, 2400, mask_max) == want, n
    for n in (800001, 10**6):
        with pytest.raises(ValueError, match="2400.*800000.*bitmask"):
            fixpoint_route(n, 2400, mask_max)
    # a card with less shared memory moves the boundary with it
    assert fixpoint_route(1056, 1024, mask_max) == "nms_mask"


def test_autoanchor_matches_reference(tmp_path):
    """fit_anchors and check_anchors: the reference's anchors and stats
    exactly, from labels and from a reader (at a reduced ``generations``)."""
    rng = np.random.default_rng(0)
    wh = np.concatenate([rng.lognormal(2.3, 0.5, (300, 2)),
                         rng.uniform(0.5, 3.0, (20, 2))])
    for seed in (0, 3):
        got = PAA.fit_anchors(wh, seed=seed, generations=60)
        want = JAA.fit_anchors(wh, seed=seed, generations=60)
        assert got == want
    flat = np.asarray([[3.0, 4.0], [9.0, 7.0], [20.0, 30.0]])
    np.testing.assert_array_equal(PAA.ratio_metric(wh, flat),
                                  JAA.ratio_metric(wh, flat))
    assert PAA.anchors_to_levels(np.arange(18.0).reshape(9, 2)) == \
        JAA.anchors_to_levels(np.arange(18.0).reshape(9, 2))
    with pytest.raises(ValueError, match="at least 9 boxes"):
        PAA.fit_anchors(wh[:5])

    # readers: COCO metadata (no image read) and VisDrone through load()
    ann, imgs = build_coco_dataset(str(tmp_path / "coco"), n_images=6)
    vi, vl = build_visdrone_dataset(str(tmp_path / "vis"), n_images=8)
    for p_ds, j_ds in ((PR.COCODataset(ann, imgs), JR.COCODataset(ann, imgs)),
                       (PR.VisDroneDataset(vi, vl),
                        JR.VisDroneDataset(vi, vl))):
        np.testing.assert_array_equal(PAA.dataset_label_wh(p_ds, 256),
                                      JAA.dataset_label_wh(j_ds, 256))
        big = (((300.0, 300.0),) * 3,) * 3    # BPR 0: refit
        for anchors in (None, big):
            got = PAA.check_anchors(p_ds, img_size=256, anchors=anchors,
                                    generations=40, seed=1)
            want = JAA.check_anchors(j_ds, img_size=256, anchors=anchors,
                                     generations=40, seed=1)
            assert got == want
        assert got[0] is not None and got[1]["prev_bpr"] < 0.98


def test_string_image_ids_reach_det_eval(tmp_path):
    """VisDrone's string stems pass EvalPipeline → EvalLoader → Evaluator →
    DetEval unchanged (a short last batch padded with None rows), and a
    step that answers each frame's own gt scores AP 1."""
    imgs, labels = build_visdrone_dataset(str(tmp_path), n_images=3, seed=7)
    ds = PR.VisDroneDataset(imgs, labels)
    size = 128
    pipe = EvalPipeline(ds, size)
    # each frame's kept gt in letterbox pixels, found by its letterbox
    by_scale = {}
    for i in range(len(ds)):
        s, raw = pipe.sample(i), PR.drop_ignore_boxes(ds.load(i))
        b = raw["boxes"] * s["scale"] + [s["pad_x"], s["pad_y"]] * 2
        by_scale[s["img_id"]] = (b, raw["classes"])
    order = [pipe.sample(i)["img_id"] for i in range(len(ds))]
    calls = []

    def step(images):
        b = images.shape[0]
        out_b = torch.zeros(b, 8, 4)
        out_s = torch.zeros(b, 8)
        out_c = torch.full((b, 8), -1, dtype=torch.int64)
        for j in range(b):
            k = len(calls) * 2 + j
            if k >= len(order):
                continue
            boxes, cls = by_scale[order[k]]
            n = len(cls)
            out_b[j, :n] = torch.from_numpy(boxes)
            out_s[j, :n] = 0.9
            out_c[j, :n] = torch.from_numpy(cls).long()
        calls.append(b)
        return out_b, out_s, out_c, out_s > 0

    det = DetEval(ds.num_classes)
    ds.gt_for_eval(det)
    with EvalLoader(pipe, 2, num_workers=1) as loader:
        stats = Evaluator(None, ds.num_classes, step_fn=step,
                          device="cpu").run(loader, det_eval=det)
    assert calls == [2, 2] and stats["num_images"] == len(ds)
    assert {img for img, _ in det._dts} == set(order)
    assert all(isinstance(img, str) for img, _ in det._gts)
    assert stats["AP"] == pytest.approx(1.0)


class _TB:
    def __init__(self, log_dir):
        pass

    def scalars(self, *a, **k):
        pass

    def close(self):
        pass


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def field(self, name):
        return [getattr(r, name) for r in self.records if hasattr(r, name)]


def test_train_dota_shaped_config(tmp_path, monkeypatch):
    """``train_from_datasets`` on the CPU with a yolov5_s_dota_1024-shaped
    config (DOTA reader, DropBlock 0.5, device_aug with mixup, autoanchor)
    at width 0.125 and 64²: one epoch of two steps, finite metrics, the
    refit anchors those of ``check_anchors`` on the same reader and in the
    loss and the in-loop eval, whose DOTA stems reach DetEval. Then the
    frozen-backbone knobs: the backbone keeps the transferred weights while
    its BatchNorm statistics and the neck move."""
    from heltondetection_tpu_torch.ops import postprocess as p_post
    from heltondetection_tpu_torch.train import yolo_loss as p_loss
    monkeypatch.setitem(p_csp.VARIANTS, "t", (0.33, 0.125))
    monkeypatch.setattr(runner, "TBWriter", _TB)
    seen = {}
    loss_cfg, fused = p_loss.YoloLossConfig, p_post.make_fused_postprocess

    def spy_loss(*a, **k):
        seen["loss"] = k.get("anchors")
        return loss_cfg(*a, **k)

    def spy_post(*a, **k):
        seen["eval"] = k.get("anchors")
        return fused(*a, **k)

    monkeypatch.setattr(p_loss, "YoloLossConfig", spy_loss)
    monkeypatch.setattr(p_post, "make_fused_postprocess", spy_post)
    dota = p_base.load_config(os.path.join(CONFIG_DIR,
                                           "yolov5_s_dota_1024.py"))
    tr = build_dota_dataset(str(tmp_path / "train"), n_images=8, seed=1)
    va = build_dota_dataset(str(tmp_path / "val"), n_images=3, seed=2)
    big = (((400.0, 400.0),) * 3,) * 3
    cfg = dataclasses.replace(
        dota, work_dir=str(tmp_path / "runs"),
        data=dataclasses.replace(dota.data, train_ann=tr[1],
                                 train_imgs=tr[0], val_ann=va[1],
                                 val_imgs=va[0], class_names=tr[2],
                                 max_boxes=8),
        model=dataclasses.replace(dota.model, variant="t", img_size=64,
                                  dropblock_p=0.5, anchors=big),
        train=dataclasses.replace(dota.train, epochs=1, batch_size=4,
                                  device_aug=True, autoanchor=True,
                                  mixup_p=0.5, num_workers=2,
                                  warmup_epochs=0.5),
        eval=dataclasses.replace(dota.eval, batch_size=2))
    runner._check_train_config(cfg)
    records = _Records()
    logging.getLogger("heltondetection_tpu_torch").addHandler(records)
    try:
        best = runner.run_train(cfg, device="cpu")
    finally:
        logging.getLogger("heltondetection_tpu_torch").removeHandler(records)
    epochs = records.field("epoch_stats")
    assert [e["steps"] for e in epochs] == [2]
    assert all(np.isfinite(v) for e in epochs for v in e.values()
               if isinstance(v, float))
    assert records.field("eval_stats") and best["num_images"] == 3
    want, st = PAA.check_anchors(runner.build_dataset(cfg.data, "train"),
                                 img_size=64, anchors=big, seed=0)
    assert want is not None and st["prev_bpr"] < 0.98
    assert cfg.model.anchors == want == records.field("autoanchor")[0][
        "anchors"]
    assert seen["loss"] == seen["eval"] == runner._cfg_anchors(cfg)
    saved = sorted(os.listdir(cfg.ckpt_dir))
    assert saved == ["2"]

    # yolov5_s_coco_640_dropblock_frozen's knobs on top: DropBlock over a
    # frozen backbone initialised from that run's checkpoint
    frozen = dataclasses.replace(
        cfg, name="frozen",
        model=dataclasses.replace(cfg.model, freeze_backbone=True),
        train=dataclasses.replace(cfg.train, pretrain_ckpt=cfg.ckpt_dir,
                                  device_aug=False, autoanchor=False))
    runner.run_train(frozen, device="cpu")

    def weights(c):
        return torch.load(os.path.join(c.ckpt_dir, "2", "train_state.pt"),
                          weights_only=True)["model"]

    before, after = weights(cfg), weights(frozen)
    conv = [k for k in after if k.endswith("conv.weight")]
    assert all(torch.equal(before[k], after[k]) for k in conv
               if k.startswith("backbone."))
    assert not all(torch.equal(before[k], after[k]) for k in conv
                   if k.startswith("neck."))
    stats = [k for k in after if k.startswith("backbone.")
             and k.endswith("running_mean")]
    assert all(bool(after[k].abs().sum() > 0) for k in stats)  # from 0

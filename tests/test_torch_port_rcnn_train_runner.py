"""The port's FasterRCNN training through its entry points on the CPU
(heltondetection_tpu_torch/engine/runner.py ``train_from_datasets`` and
``run_train``, cli.py ``--mode train``), the backbone swap's train config
and the head's DropBlock.

``train_from_datasets`` runs a tiny FasterRCNN (64²)
on in-memory frames for 2 epochs of 2 steps with its in-loop eval, then
resumes for a third: the checkpoint keeps the sampling generator's state,
``load_detector`` serves the run's EMA weights and
``train.backbone_pretrain`` grafts a torchvision ResNet18 before the EMA is
made. TensorBoard is stubbed: importing it costs seconds.
"""

import logging
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from heltondetection_tpu_torch import cli
from heltondetection_tpu_torch.configs import base as p_base
from heltondetection_tpu_torch.engine import runner
from heltondetection_tpu_torch.engine.infer import Detector
from heltondetection_tpu_torch.models import faster_rcnn as PR
from heltondetection_tpu_torch.utils.convert import from_jax_variables

from torch_rcnn_refs import draw_variables

SIZE = 64
NC = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def work(tmp_path):
    """``tmp_path``, removed after the test: one checkpoint of a tiny
    FasterRCNN holds about 1 GB (its box head's two 12544→1024 dense
    layers with their Adam moments and EMA)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


class _Frames:
    """An in-memory reader: seeded noise frames with 1-3 filled boxes."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.num_classes = NC
        self.label_to_cat = {i: i for i in range(NC)}
        self.frames = []
        for _ in range(n):
            h, w = int(rng.integers(48, 96)), int(rng.integers(48, 96))
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            k = int(rng.integers(1, 4))
            wh = rng.uniform(0.2, 0.6, (k, 2)) * [w, h]
            xy = rng.uniform(0, 1, (k, 2)) * ([w, h] - wh)
            boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
            cls = rng.integers(0, NC, k).astype(np.int32)
            for (x1, y1, x2, y2), c in zip(boxes.astype(int), cls):
                img[y1:y2, x1:x2] = 80 * c
            self.frames.append((img, boxes, cls))

    def __len__(self):
        return len(self.frames)

    def load(self, i):
        img, boxes, cls = self.frames[i]
        return {"image": img, "boxes": boxes, "classes": cls,
                "iscrowd": np.zeros(len(cls), np.int32), "img_id": i,
                "file": f"{i}.png"}

    def gt_for_eval(self, det_eval):
        for i, (_, b, c) in enumerate(self.frames):
            det_eval.add_gt(i, np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]],
                                              1), c)


class _TB:
    def __init__(self, log_dir):
        pass

    def scalars(self, step, values, prefix=""):
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


def _rcnn_config(work, **train):
    return p_base.ExperimentConfig(
        name="rcnn_train", work_dir=work,
        data=p_base.DataConfig(max_boxes=4),
        model=p_base.ModelConfig(family="faster_rcnn", backbone="resnet18",
                                 num_classes=NC, img_size=SIZE,
                                 neck="pafpn_v8", head="decoupled",
                                 rpn_pre_nms_topk=64, rpn_post_nms_topk=16,
                                 rpn_batch=32, box_batch=16),
        train=p_base.TrainConfig(**{
            "epochs": 2, "batch_size": 2, "lr": 1e-3, "warmup_epochs": 0.5,
            "num_workers": 0, "eval_interval": 1, "ckpt_interval": 2,
            **train}),
        eval=p_base.EvalConfig(batch_size=2, conf_thres=0.001))


def _torchvision_resnet18(path):
    """A torchvision-layout ResNet18 state dict of drawn weights, written
    by the reference's exporter."""
    from heltondetection_tpu.models.resnet import ResNet as JResNet
    from heltondetection_tpu.utils.torch_convert import (
        export_resnet_state_dict, save_torch_state_dict)
    shapes = jax.eval_shape(lambda k, x: JResNet(
        stage_sizes=(2, 2, 2, 2), block="basic").init(k, x),
        jax.random.PRNGKey(0), jax.numpy.zeros((1, 64, 64, 3)))
    v = draw_variables(shapes, seed=71)
    save_torch_state_dict(path, export_resnet_state_dict(v["params"],
                                                         v["batch_stats"]))
    return from_jax_variables(v)


def test_train_from_datasets_trains_resumes_and_serves(work, monkeypatch):
    """A tiny FasterRCNN through ``train_from_datasets`` with
    ``backbone_pretrain``: 2 epochs x 2 steps with finite metrics, the
    in-loop eval after each epoch, ``train_state.pt`` holding the sampling
    generator's state (that of a generator seeded ``seed + 1`` after four
    steps' draws); the frozen stem keeps the grafted weights in the model
    and the EMA; a resume with ``epochs=3`` continues at step 4 for two
    more steps; ``load_detector`` serves the saved EMA weights."""
    monkeypatch.setattr(runner, "TBWriter", _TB)
    pretrained = _torchvision_resnet18(str(work / "r18.pth"))
    cfg = _rcnn_config(str(work / "runs"),
                       backbone_pretrain=str(work / "r18.pth"))
    train_ds, val_ds = _Frames(4, 1), _Frames(2, 2)
    rec = _Records()
    log = logging.getLogger("heltondetection_tpu_torch")
    log.addHandler(rec)
    try:
        runner.train_from_datasets(cfg, train_ds, val_ds, device="cpu")
        epochs2, evals2 = rec.field("epoch_stats"), rec.field("eval_stats")
        messages = [r.getMessage() for r in rec.records]
        rec.records.clear()
        cfg.train.epochs = 3
        runner.train_from_datasets(cfg, train_ds, val_ds, device="cpu")
        epochs3, resumed = rec.field("epoch_stats"), rec.field("resumed_step")
    finally:
        log.removeHandler(rec)
    assert [e["steps"] for e in epochs2] == [2, 2] and len(evals2) == 2
    assert all(np.isfinite(e[k]) for e in epochs2
               for k in ("rpn_obj", "rpn_reg", "cls", "box", "total",
                         "grad_norm"))
    assert any("pretrained backbone" in m for m in messages)
    assert not any("FROM SCRATCH" in m for m in messages)
    assert resumed == [4] and [(e["epoch"], e["step"]) for e in epochs3] \
        == [(2, 6)]
    saved = torch.load(os.path.join(cfg.ckpt_dir, "4", "train_state.pt"),
                       weights_only=True)
    gen = torch.Generator().manual_seed(cfg.train.seed + 1)
    n_anchors = PR.pyramid_anchors(SIZE)[0].shape[0]
    for _ in range(4):
        PR.draw_sampling(gen, 2, n_anchors, 16 + 4)
    assert torch.equal(saved["rng"], gen.get_state())
    for k in ("stem_conv.weight", "layer1_0.conv1.weight"):
        assert torch.equal(saved["model"][f"backbone.{k}"], pretrained[k])
        assert torch.equal(saved["ema"][f"backbone.{k}"], pretrained[k])
    final = torch.load(os.path.join(cfg.ckpt_dir, "6", "train_state.pt"),
                       weights_only=True)
    served = runner.load_detector(cfg, ckpt=cfg.ckpt_dir, device="cpu")
    model = runner.build_model(cfg.model, NC)
    model.load_state_dict({**final["model"], **final["ema"]})
    by_hand = Detector(None, NC, SIZE, forward_fn=runner.forward_for_eval(
        model, NC, device="cpu"), conf_thres=cfg.test.conf_thres,
        iou_thres=cfg.test.iou_thres, device="cpu")
    frames = [f[0] for f in val_ds.frames]
    for got, want in zip(served.detect_batch(frames),
                         by_hand.detect_batch(frames)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_cli_trains_faster_rcnn_and_warns_from_scratch(work, monkeypatch):
    """``cli.py --mode train --device cpu`` on a FasterRCNN config file
    (COCO files on disk, one epoch of one step, DropBlock on the pooled
    crops): it trains, checkpoints and warns that the frozen stem and
    FrozenBN assume a pretrained backbone; the published FasterRCNN
    configs and the backbone swap pass the train config check;
    ``multi_scale`` is refused for FasterRCNN, and ``spatial_shards`` in
    one process with the reference's refusal (it runs over ranks:
    tests/test_torch_port_spatial.py)."""
    from synth_data import build_coco_dataset
    monkeypatch.setattr(runner, "TBWriter", _TB)
    ann, imgs = build_coco_dataset(str(work / "coco"), n_images=2,
                                   hw=(48, 64), num_classes=NC)
    path = work / "rcnn_cfg.py"
    path.write_text(
        "from heltondetection_tpu_torch.configs import base as b\n"
        f"config = b.ExperimentConfig(name='cli_rcnn', work_dir="
        f"{str(work / 'runs')!r}, model=b.ModelConfig(family="
        f"'faster_rcnn', backbone='resnet18', num_classes={NC}, img_size="
        f"{SIZE}, neck='fpn', head='coupled', roi_levels=1, "
        f"roi_method='pool', dropblock_p=0.5, rpn_pre_nms_topk=32, "
        f"rpn_post_nms_topk=8, rpn_batch=16, box_batch=8), "
        f"data=b.DataConfig(train_ann={ann!r}, train_imgs={imgs!r}, "
        f"max_boxes=4), train=b.TrainConfig(epochs=1, batch_size=2, "
        f"num_workers=0))\n")
    rec = _Records()
    log = logging.getLogger("heltondetection_tpu_torch")
    log.addHandler(rec)
    try:
        assert cli.main(["--mode", "train", "--config", str(path),
                         "--device", "cpu"]) == 0
    finally:
        log.removeHandler(rec)
    stats = rec.field("epoch_stats")
    assert len(stats) == 1 and np.isfinite(stats[0]["total"])
    assert any("FROM SCRATCH" in r.getMessage() for r in rec.records)
    cfg = p_base.load_config(str(path))
    assert os.path.isfile(os.path.join(cfg.ckpt_dir, "1", "train_state.pt"))

    configs = os.path.join(os.path.dirname(runner.__file__), "..", "configs")
    for name in sorted(os.listdir(configs)):
        if name.startswith("faster_rcnn_") or name == \
                "yolov5_l_voc_640_backbone_swap.py":
            runner._check_train_config(p_base.load_config(
                os.path.join(configs, name)))
    cfg.train.multi_scale = (0.5, 1.0)
    with pytest.raises(ValueError, match="multi_scale"):
        runner._check_train_config(cfg)
    cfg.train.multi_scale = ()
    cfg.train.spatial_shards = 2
    with pytest.raises(ValueError, match="one process"):
        runner.train_from_datasets(cfg, [], None, device="cpu")


def test_head_dropblock_acts_in_training_only():
    """A FasterRCNN with ``dropblock_p`` drops blocks of its pooled crops in
    training mode (fresh draws each call, repeatable by seed) and not in
    eval mode; the reference cannot build this head (its DropBlock is made
    outside a compact method), so the port is held to its own eval
    mode."""
    with torch.device("meta"):
        pm = PR.FasterRCNN(PR.RCNNConfig(num_classes=NC, img_size=SIZE,
                                         backbone="resnet18",
                                         dropblock_p=0.5))
    pm = pm.to_empty(device="cpu")
    from heltondetection_tpu_torch.models.common import init_weights
    from heltondetection_tpu_torch.models.dropblock import reseed_dropblock
    init_weights(pm, torch.Generator().manual_seed(0))
    x = torch.rand(1, SIZE, SIZE, 3,
                   generator=torch.Generator().manual_seed(1))
    rois = torch.tensor([[[4.0, 4.0, 40.0, 44.0], [10.0, 2.0, 60.0, 30.0]]])
    with torch.no_grad():
        pyr = pm.eval().features(x)
        plain = pm.run_box_head(pyr, rois)
        pm.train()
        reseed_dropblock(pm, 0, 0)
        a = pm.run_box_head(pyr, rois)
        b = pm.run_box_head(pyr, rois)
        reseed_dropblock(pm, 0, 0)
        again = pm.run_box_head(pyr, rois)
    assert not torch.equal(a[0], plain[0]) and not torch.equal(a[0], b[0])
    assert torch.equal(a[0], again[0])
    pm.eval()
    with torch.no_grad():
        assert torch.equal(pm.run_box_head(pyr, rois)[0], plain[0])

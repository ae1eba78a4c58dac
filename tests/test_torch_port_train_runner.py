"""The port's training orchestration on the CPU
(heltondetection_tpu_torch/engine/runner.py: ``run_train`` with its
in-loop ``run_eval``, checkpoints and resume; ``cli.py --mode
train|eval``).

``run_train`` trains a YOLOv5s (full width) at 64² on 8 COCO images
(batch 4, two epochs, then a resumed third) and is held to the same steps
driven by hand through the port's public pieces, exactly (one thread, the
same operations in the same order), on the train pipeline ``run_train``
picks: the native one where the loader core builds (the config's default
``train.native_loader``); a second, one-epoch run with
``train.native_loader=False`` pins the Python pipeline the same way. The
two pipelines' pixels differ by a few grey levels (OpenCV against torch),
so each side builds the pipeline of its run. The in-loop eval must score each
call's own weights: the reference's ``summarize`` reused its first
``accumulate`` after ``reset_dets`` and so reported stale stats; the port
does not copy that. TensorBoard is stubbed: importing it costs seconds.
"""

import json
import logging
import os
import textwrap

import numpy as np
import pytest
import torch

from heltondetection_tpu_torch import cli
from heltondetection_tpu_torch.configs import base as p_base
from heltondetection_tpu_torch.data.augment import TrainPipeline
from heltondetection_tpu_torch.data.loader import TrainLoader
from heltondetection_tpu_torch.engine import runner
from heltondetection_tpu_torch.models.common import init_weights
from heltondetection_tpu_torch.train.schedule import make_optimizer
from heltondetection_tpu_torch.train.trainer import (create_train_state,
                                                     make_train_step)
from heltondetection_tpu_torch.train.yolo_loss import YoloLossConfig
from heltondetection_tpu_torch.utils import ckpt as ckpt_io

from synth_data import build_coco_dataset

SIZE = 64


class _TB:
    """TensorBoard stand-in that records the scalars."""
    written = []

    def __init__(self, log_dir):
        pass

    def scalars(self, step, values, prefix=""):
        _TB.written.append((step, prefix, dict(values)))

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


def _config(root, name="run", epochs=2):
    train_ann, train_imgs = build_coco_dataset(os.path.join(root, "train"),
                                               n_images=8, seed=1)
    val_ann, val_imgs = build_coco_dataset(os.path.join(root, "val"),
                                           n_images=4, seed=2)
    return p_base.ExperimentConfig(
        name=name, work_dir=os.path.join(root, "runs"),
        data=p_base.DataConfig(train_ann=train_ann, train_imgs=train_imgs,
                               val_ann=val_ann, val_imgs=val_imgs,
                               max_boxes=8),
        model=p_base.ModelConfig(variant="s", img_size=SIZE),
        train=p_base.TrainConfig(epochs=epochs, batch_size=4, lr=1e-3,
                                 warmup_epochs=0.5, num_workers=2,
                                 eval_interval=1, ckpt_interval=1),
        eval=p_base.EvalConfig(batch_size=4))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs, then the same config resumed with ``epochs=3``."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("train"))
    cfg = _config(root)
    rec = _Records()
    log = logging.getLogger("heltondetection_tpu_torch")
    log.addHandler(rec)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(runner, "TBWriter", _TB)
            best2 = runner.run_train(cfg, device="cpu")
            first = list(rec.records)
            rec.records.clear()
            cfg.train.epochs = 3
            best3 = runner.run_train(cfg, device="cpu")
        yield {"cfg": cfg, "best2": best2, "best3": best3, "first": first,
               "resumed": list(rec.records), "root": root}
    finally:
        log.removeHandler(rec)
        torch.set_num_threads(prev)


def _by_hand(cfg, epochs_total, start_state=None, from_epoch=0,
             to_epoch=2):
    """The steps of ``run_train`` driven through the port's public pieces:
    seeded init, the pipeline ``run_train`` picks (native where
    ``train.native_loader`` is set and the loader core builds) and the
    loader, the optimizer over all epochs, the packed train step."""
    nc = 4
    model = runner.build_model(cfg.model, nc)
    init_weights(model, torch.Generator().manual_seed(cfg.train.seed))
    model = model.to(memory_format=torch.channels_last)
    ds = runner.build_dataset(cfg.data, "train")
    native, _ = runner._native_pipelines(cfg)
    pipe = (native.NativeTrainPipeline if native is not None
            else TrainPipeline)(ds, SIZE, max_boxes=8, seed=cfg.train.seed)
    loader = TrainLoader(pipe, 4, seed=cfg.train.seed, num_workers=0,
                         device="cpu")
    opt = make_optimizer(model, 1e-3, total_steps=2 * epochs_total,
                         warmup_steps=1)
    model.packed_train = True
    state = create_train_state(model, opt)
    if start_state is not None:
        ckpt_io.restore_state(cfg.ckpt_dir, state, step=start_state)
    step = make_train_step(YoloLossConfig(num_classes=nc, img_size=SIZE))
    for epoch in range(from_epoch, to_epoch):
        for batch in loader.epoch(epoch):
            state, _ = step(state, batch)
    return state


def _assert_state_equal(state, saved):
    own = state.model.state_dict()
    assert own.keys() == saved["model"].keys()
    for k, v in own.items():
        assert torch.equal(v, saved["model"][k]), k
    for k, v in state.ema.items():
        assert torch.equal(v, saved["ema"][k]), k
    assert state.step == saved["step"]


def _train_state(cfg, step):
    return torch.load(os.path.join(cfg.ckpt_dir, str(step),
                                   "train_state.pt"), weights_only=True)


def test_run_train_writes_checkpoints_and_logs(trained):
    cfg = trained["cfg"]
    assert sorted(os.listdir(cfg.ckpt_dir)) == ["2", "4", "6"]
    for step in ("2", "4", "6"):
        assert sorted(os.listdir(os.path.join(cfg.ckpt_dir, step))) == \
            ["eval_variables.pt", "train_state.pt"]
    assert len(os.listdir(cfg.best_ckpt_dir)) == 1         # one slot
    with open(os.path.join(cfg.work_dir, cfg.name, "best.json")) as f:
        best = json.load(f)
    assert best["AP"] == trained["best3"]["AP"] and best["step"] in (2, 4, 6)
    assert os.path.isfile(os.path.join(cfg.log_dir, "train.log"))
    epochs = [r.epoch_stats for r in trained["first"]
              if hasattr(r, "epoch_stats")]
    assert [(e["epoch"], e["steps"], e["step"]) for e in epochs] == \
        [(0, 2, 2), (1, 2, 4)]
    assert all(np.isfinite(v) for e in epochs for v in e.values())
    assert len([r for r in trained["first"] if hasattr(r, "eval_stats")]) \
        == 2
    assert any(p == "train/" for _, p, _ in _TB.written)
    assert any(p == "val/" for _, p, _ in _TB.written)


def test_run_train_equals_the_steps_by_hand(trained):
    """Steps 1–4 driven by hand give the step-4 checkpoint exactly:
    weights, BatchNorm statistics, EMA and step."""
    cfg = trained["cfg"]
    _assert_state_equal(_by_hand(cfg, 2), _train_state(cfg, 4))


def test_run_train_equals_the_steps_by_hand_on_the_python_pipeline(
        tmp_path, monkeypatch):
    """``train.native_loader=False`` pins the Python ``TrainPipeline``
    (logged with the reason): one epoch of ``run_train`` without a val set
    equals its two steps by hand on that pipeline, exactly."""
    monkeypatch.setattr(runner, "TBWriter", _TB)
    cfg = _config(str(tmp_path), name="python", epochs=1)
    cfg.data.val_ann = ""
    cfg.train.native_loader = False
    rec = _Records()
    log = logging.getLogger("heltondetection_tpu_torch")
    log.addHandler(rec)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runner.run_train(cfg, device="cpu")
        state = _by_hand(cfg, 1, to_epoch=1)
    finally:
        torch.set_num_threads(prev)
        log.removeHandler(rec)
    assert rec.field("train_loader") == [{
        "pipeline": "TrainPipeline", "native": False,
        "why": "train.native_loader is off"}]
    _assert_state_equal(state, _train_state(cfg, 2))


def test_run_train_and_its_eval_take_the_native_pipelines(trained):
    """Where the loader core builds, ``run_train`` trains on
    ``NativeTrainPipeline`` and its in-loop ``run_eval`` scores through
    ``NativeEvalPipeline``; each says so once in the log."""
    native, why = runner._native_pipelines(trained["cfg"])
    if native is None:
        pytest.skip(f"the native loader core does not build here: {why}")
    first = [r for r in trained["first"] if hasattr(r, "train_loader")]
    assert [r.train_loader for r in first] == [{
        "pipeline": "NativeTrainPipeline", "native": True, "why": None}]
    messages = [r.getMessage() for r in trained["first"]]
    assert messages.count("eval loader: NativeEvalPipeline (C++)") == 1


def test_resume_restores_and_trains_one_more_epoch(trained):
    """``epochs=3`` resumes from step 4 and trains steps 5–6 only; they
    equal the same two steps by hand from the step-4 checkpoint (the
    schedule now spans three epochs, as in a resumed reference run)."""
    cfg = trained["cfg"]
    recs = trained["resumed"]
    assert [r.resumed_step for r in recs if hasattr(r, "resumed_step")] \
        == [4]
    epochs = [r.epoch_stats for r in recs if hasattr(r, "epoch_stats")]
    assert [(e["epoch"], e["steps"], e["step"]) for e in epochs] == \
        [(2, 2, 6)]
    state = _by_hand(cfg, 3, start_state=4, from_epoch=2, to_epoch=3)
    _assert_state_equal(state, _train_state(cfg, 6))


def test_load_detector_serves_the_runs_ema(trained):
    """``load_detector`` reads the work dir's newest checkpoint: the EMA
    weights (and the BatchNorm statistics) the run wrote."""
    cfg = trained["cfg"]
    saved = _train_state(cfg, 6)
    ev = ckpt_io.restore_eval_variables(cfg.ckpt_dir)
    for k, v in saved["ema"].items():
        assert torch.equal(ev["ema"][k], v), k
    det = runner.load_detector(cfg, device="cpu")
    model = runner.build_model(cfg.model, 4)
    model.load_state_dict({**saved["model"], **saved["ema"]})
    by_hand = runner._make_detector(cfg, model, 4, device="cpu")
    frame = np.random.default_rng(0).integers(0, 256, (96, 128, 3)).astype(
        np.uint8)
    for g, w in zip(det.detect_image(frame), by_hand.detect_image(frame)):
        np.testing.assert_array_equal(g, w)


def test_in_loop_eval_scores_each_calls_weights(trained):
    """Reusing the val set, the gt-registered DetEval and the network across
    calls, each call scores its own weights: stats change when the
    weights change and equal a one-shot eval of the same weights."""
    cfg = trained["cfg"]
    model = runner.build_model(cfg.model, 4)
    ev = ckpt_io.restore_eval_variables(cfg.ckpt_dir)
    trained_w = ev["ema"]
    init_w = dict(trained_w)
    init_weights(model, torch.Generator().manual_seed(9))
    init_w.update({k: v for k, v in model.state_dict().items()
                   if "running" not in k and "num_batches" not in k})
    reuse = {}
    a = runner.run_eval(cfg, trained_w, model, verbose=False, _reuse=reuse,
                        device="cpu")
    b = runner.run_eval(cfg, init_w, model, verbose=False, _reuse=reuse,
                        device="cpu")
    one_shot = runner.run_eval(cfg, init_w, model, verbose=False,
                               device="cpu")
    keys = [k for k in a if k not in ("images_per_sec",)]
    assert [b[k] for k in keys] != [a[k] for k in keys]
    assert [b[k] for k in keys] == [one_shot[k] for k in keys]
    assert a["num_images"] == 4


def test_cli_train_and_eval(trained, tmp_path, capsys):
    cfg = trained["cfg"]
    path = tmp_path / "cfg.py"
    path.write_text(textwrap.dedent(f"""
        from heltondetection_tpu_torch.configs.base import (
            DataConfig, EvalConfig, ExperimentConfig, ModelConfig,
            TrainConfig)
        config = ExperimentConfig(
            name="cli", work_dir={str(tmp_path)!r},
            data=DataConfig(train_ann={cfg.data.train_ann!r},
                            train_imgs={cfg.data.train_imgs!r},
                            val_ann={cfg.data.val_ann!r},
                            val_imgs={cfg.data.val_imgs!r}, max_boxes=8),
            model=ModelConfig(variant="n", img_size={SIZE}),
            train=TrainConfig(epochs=1, batch_size=4, num_workers=0),
            eval=EvalConfig(batch_size=4))
    """))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(runner, "TBWriter", _TB)
        assert cli.main(["--mode", "train", "--config", str(path),
                         "--device", "cpu", "--no-resume"]) == 0
        assert "best val" in capsys.readouterr().out
        assert cli.main(["--mode", "eval", "--config", str(path),
                         "--device", "cpu"]) == 0
    assert ckpt_io.latest_step(str(tmp_path / "cli" / "ckpt")) == 2


@pytest.mark.parametrize("entry", ["run_train", "train_from_datasets",
                                   "run_eval", "TrainLoader", "cli_train",
                                   "cli_eval"])
def test_entry_points_raise_without_cuda(entry, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = p_base.ExperimentConfig(work_dir=str(tmp_path))
    config = os.path.join(os.path.dirname(runner.__file__), "..", "configs",
                          "yolov5_s_coco_640.py")
    call = {
        "run_train": lambda: runner.run_train(cfg),
        "train_from_datasets": lambda: runner.train_from_datasets(cfg, [],
                                                                  None),
        "run_eval": lambda: runner.run_eval(cfg),
        "TrainLoader": lambda: TrainLoader([], 4),
        "cli_train": lambda: cli.main(["--mode", "train", "--config",
                                       config]),
        "cli_eval": lambda: cli.main(["--mode", "eval", "--config",
                                      config]),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


@pytest.mark.parametrize("change, refusal", [
    ({"model.backbone": "cspdarknet_l", "train.spatial_shards": 2},
     "one process"),
    ({"train.backbone_pretrain": "r50.pth", "train.spatial_shards": 2},
     "one process"),
    ({"train.spatial_shards": 2}, "one process"),
    ({"train.spatial_shards": 2, "train.device_aug": True}, "device_aug"),
    ({"model.family": "faster_rcnn", "train.spatial_shards": 2},
     "one process"),
], ids=[f"change{i}-A14" for i in range(5)])
def test_not_ported_train_options_raise(change, refusal, tmp_path):
    """``train.spatial_shards`` (A14b, ported) is refused where the
    reference refuses it, before any data is read: with ``device_aug``,
    and in one process, whose ranks are no devices to split the rows
    over (tests/test_torch_port_spatial.py runs it over four ranks)."""
    cfg = p_base.ExperimentConfig(work_dir=str(tmp_path))
    for key, value in change.items():
        part, field = key.split(".")
        setattr(getattr(cfg, part), field, value)
    with pytest.raises(ValueError, match=refusal):
        runner.train_from_datasets(cfg, [], None, device="cpu")


def test_not_ported_eval_and_data_parts_raise(tmp_path):
    """``dump_json`` writes the dets as a COCO results list (ported with
    the eval artifacts); ``eval.int8``, which raised until int8 was
    ported, now scores the int8 program and caches its quant tree beside
    the run (tests/test_torch_port_int8.py holds it to the reference)."""
    val_ann, val_imgs = build_coco_dataset(str(tmp_path / "val"),
                                           n_images=2, seed=2)
    cfg = p_base.ExperimentConfig(
        work_dir=str(tmp_path), model=p_base.ModelConfig(img_size=SIZE),
        data=p_base.DataConfig(val_ann=val_ann, val_imgs=val_imgs),
        eval=p_base.EvalConfig(batch_size=2, conf_thres=0.001))
    model = runner.build_model(cfg.model, 4)
    init_weights(model, torch.Generator().manual_seed(9))
    out = tmp_path / "dets.json"
    runner.run_eval(cfg, model.state_dict(), model, verbose=False,
                    dump_json=str(out), device="cpu")
    dets = json.loads(out.read_text())
    assert isinstance(dets, list) and len(dets) > 0
    assert set(dets[0]) == {"image_id", "category_id", "bbox", "score"}
    assert {d["category_id"] for d in dets} <= {10, 11, 12, 13}
    cfg.eval.int8 = True
    stats = runner.run_eval(cfg, model.state_dict(), model, verbose=False,
                            device="cpu")
    assert 0.0 <= stats["AP"] <= 1.0
    assert (tmp_path / cfg.name / "int8_quant.npz").exists()

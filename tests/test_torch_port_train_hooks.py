"""The port's ``train_from_datasets`` around its loader and its two
environment hooks, on the CPU (heltondetection_tpu_torch/engine/runner.py).

* The pipeline choice: a loader core that does not build sends training and
  the in-loop eval to the Python pipelines, and the log gives the
  compiler's reason; a FasterRCNN on the native loader gets
  ``gt_boxes_xyxy`` on whole native batches equal to the per-sample
  ``_XyxyTargets.sample`` path's (its step is swapped for a recorder).
* ``HELTON_PROFILE_DIR`` writes a ``torch.profiler`` trace of the run;
  ``HELTON_DEBUG_NANS`` turns a poisoned weight into a
  ``FloatingPointError`` naming epoch 0 and step 0 and restores autograd's
  anomaly mode after; without it, no step is checked.

A YOLOv5 at width 0.125 and 64² on in-memory frames, one epoch of one or
two steps, keeps each run to about a second.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from heltondetection_tpu_torch import native
from heltondetection_tpu_torch.configs import base as p_base
from heltondetection_tpu_torch.engine import runner
from heltondetection_tpu_torch.models import common as p_common
from heltondetection_tpu_torch.models import cspdarknet as p_csp
from heltondetection_tpu_torch.train import trainer as p_trainer

SIZE = 64
NC = 3


class _Frames:
    """An in-memory reader: seeded noise frames with 1-3 filled boxes."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.num_classes = NC
        self.frames = []
        for _ in range(n):
            h, w = int(rng.integers(48, 96)), int(rng.integers(48, 96))
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            k = int(rng.integers(1, 4))
            wh = rng.uniform(0.2, 0.6, (k, 2)) * [w, h]
            xy = rng.uniform(0, 1, (k, 2)) * ([w, h] - wh)
            boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
            cls = rng.integers(0, NC, k).astype(np.int32)
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


@pytest.fixture
def records():
    rec = _Records()
    log = logging.getLogger("heltondetection_tpu_torch")
    log.addHandler(rec)
    yield rec
    log.removeHandler(rec)


@pytest.fixture(autouse=True)
def _narrow(monkeypatch):
    """A YOLOv5 at width 0.125, one thread, TensorBoard stubbed, and
    neither hook variable inherited from the environment."""
    monkeypatch.setitem(p_csp.VARIANTS, "t", (0.33, 0.125))
    monkeypatch.setattr(runner, "TBWriter", _TB)
    monkeypatch.delenv("HELTON_PROFILE_DIR", raising=False)
    monkeypatch.delenv("HELTON_DEBUG_NANS", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _config(work, **model):
    return p_base.ExperimentConfig(
        name="hooks", work_dir=str(work),
        data=p_base.DataConfig(max_boxes=4),
        model=p_base.ModelConfig(**{"variant": "t", "img_size": SIZE,
                                    "num_classes": NC, **model}),
        train=p_base.TrainConfig(epochs=1, batch_size=2, lr=1e-3,
                                 warmup_epochs=0.5, num_workers=0),
        eval=p_base.EvalConfig(batch_size=2, conf_thres=0.001))


def test_a_core_that_does_not_build_falls_back_and_says_why(
        tmp_path, monkeypatch, records):
    """A loader source that does not compile: ``get_loader_lib`` is None,
    ``loader_build_error`` holds g++'s message, and training and its eval
    run on the Python pipelines, each logging that message once."""
    bad = tmp_path / "loader_core.cpp"
    bad.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(native, "_LDR_SRC", bad)
    monkeypatch.setattr(native, "_LDR_TRIED", False)
    monkeypatch.setattr(native, "_LDR_LIB", None)
    monkeypatch.setattr(native, "_LDR_ERROR", None)
    runner.train_from_datasets(_config(tmp_path), _Frames(2, 1),
                               _Frames(2, 2), device="cpu")
    assert native.get_loader_lib() is None
    assert "no_such_header_here.h" in native.loader_build_error()
    [choice] = [r.train_loader for r in records.records
                if hasattr(r, "train_loader")]
    assert choice["pipeline"] == "TrainPipeline" and not choice["native"]
    assert "no_such_header_here.h" in choice["why"]
    evals = [r.getMessage() for r in records.records
             if r.getMessage().startswith("eval loader:")]
    assert len(evals) == 1 and "Python EvalPipeline" in evals[0] \
        and "no_such_header_here.h" in evals[0]


def test_rcnn_native_batches_carry_xyxy_boxes(tmp_path, monkeypatch):
    """FasterRCNN's targets on the native loader: the batches its step gets
    carry ``gt_boxes_xyxy`` (from ``_XyxyTargets.sample_batch`` on a whole
    batch) equal to ``_XyxyTargets.sample`` of the same indices, and the
    images with them."""
    from heltondetection_tpu_torch.data import native_loader as PN
    if not PN.native_loader_available():
        pytest.skip(f"the native loader core does not build here: "
                    f"{native.loader_build_error()}")
    seen = []

    def recorder(**kw):
        def step(state, batch, draws=None):
            seen.append({k: v.clone() for k, v in batch.items()})
            state.step += 1
            return state, {"total": torch.zeros(())}
        return step

    class _NoWriter:
        def __init__(self, *a, **k):
            pass

        def save(self, state, step):
            pass

        def close(self):
            pass

    monkeypatch.setattr(p_trainer, "make_rcnn_train_step", recorder)
    monkeypatch.setattr(runner.ckpt_io, "CheckpointWriter", _NoWriter)
    cfg = _config(tmp_path, family="faster_rcnn", backbone="resnet18",
                  rpn_pre_nms_topk=32, rpn_post_nms_topk=8, rpn_batch=16,
                  box_batch=8)
    cfg.train.batch_size = 3
    ds = _Frames(6, 3)
    runner.train_from_datasets(cfg, ds, None, device="cpu")
    assert len(seen) == 2
    assert set(seen[0]) == {"image", "gt_boxes_xyxy", "gt_cls", "gt_mask"}
    tc = cfg.train
    per_sample = runner._XyxyTargets(PN.NativeTrainPipeline(
        ds, SIZE, mosaic_p=tc.mosaic_p, hsv=tc.hsv, flip_p=tc.flip_p,
        mixup_p=tc.mixup_p, max_boxes=4, seed=tc.seed))
    assert hasattr(per_sample, "sample_batch")
    assert not hasattr(runner._XyxyTargets(object()), "sample_batch")
    order = np.random.default_rng(
        np.random.SeedSequence([tc.seed, 0])).permutation(6)
    for b, batch in enumerate(seen):
        for row, idx in enumerate(order[3 * b:3 * b + 3]):
            want = per_sample.sample(int(idx), 0)
            for k in ("image", "gt_boxes_xyxy", "gt_cls", "gt_mask"):
                assert np.array_equal(batch[k][row].numpy(), want[k]), k
    assert (seen[0]["gt_mask"].sum() > 0)


def test_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    """``HELTON_PROFILE_DIR``: one step under ``torch.profiler``, its Chrome
    trace in the directory naming the forward's convolutions; the steps
    are not checked for NaNs without ``HELTON_DEBUG_NANS``."""
    def unexpected(*a):
        raise AssertionError("a step was checked without HELTON_DEBUG_NANS")

    monkeypatch.setattr(runner, "_check_finite", unexpected)
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("HELTON_PROFILE_DIR", str(trace_dir))
    runner.train_from_datasets(_config(tmp_path / "run"), _Frames(2, 4),
                               None, device="cpu")
    [name] = os.listdir(trace_dir)
    assert name == f"train-{os.getpid()}.pt.trace.json"
    events = json.loads((trace_dir / name).read_text())["traceEvents"]
    assert any(e.get("name") == "aten::conv2d" for e in events)


def test_debug_nans_names_the_poisoned_step(tmp_path, monkeypatch):
    """``HELTON_DEBUG_NANS`` with a NaN in the stem's weight: the first
    step raises ``FloatingPointError`` naming epoch 0 step 0, and
    autograd's anomaly mode is off again after; the finite check alone
    names the metric that is not finite."""
    init = p_common.init_weights

    def poisoned(model, gen):
        init(model, gen)
        with torch.no_grad():
            next(model.parameters()).view(-1)[0] = float("nan")

    monkeypatch.setattr(p_common, "init_weights", poisoned)
    monkeypatch.setenv("HELTON_DEBUG_NANS", "1")
    with pytest.raises(FloatingPointError, match="epoch 0 step 0"):
        runner.train_from_datasets(_config(tmp_path), _Frames(2, 5), None,
                                   device="cpu")
    assert not torch.is_anomaly_enabled()
    with pytest.raises(FloatingPointError,
                       match="non-finite obj at epoch 3 step 7"):
        runner._check_finite({"box": torch.tensor(1.0),
                              "obj": torch.tensor(float("inf"))}, 3, 7)
    runner._check_finite({"box": torch.tensor(1.0)}, 0, 0)

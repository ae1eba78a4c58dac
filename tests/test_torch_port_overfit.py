"""The port's counterpart of the JAX package's overfit protocol
(tests/test_e2e.py::test_overfit_train_then_eval_map and
tests/test_quant.py::test_int8_ap_delta_on_trained_net): a tiny YOLOv5
(width 0.125) overfit on 8 synthetic COCO frames at 64², 300 steps of
AdamW 5e-3 with 20 warmup steps and no mosaic, HSV or flip, then its EMA
weights scored in float and in both int8 modes through the packed serve
step and the Evaluator, on the CPU.

The port trains from the reference's initial weights (its
``create_train_state``'s init at ``PRNGKey(0)``, through
``utils/convert.py:from_jax_variables``), so the one training run is the
reference's protocol end to end. The int8 bars below depend on that
draw: in CPU runs of the reference's protocol at ``PRNGKey(2)`` and
``PRNGKey(3)`` the reference itself misses them (layer AP 0.73 against
float 0.99; AP50 0.94 against 0.96), and the port from its own
``init_weights`` at seed 0 trains to float AP 0.964 and flow AP 0.79;
on such weights the reference's int8 scores as the port's does (layer
0.78 and flow 0.75 against 0.78 and 0.77).

Without augmentation the pipeline gives every epoch the same 8 samples
(only their order moves, and one batch holds them all); that is checked
once, and the steps then run on that batch.

The bars are the reference's own, on weights trained here (random
weights cannot carry them: with no logit margins, noise reorders whole
bands of near-tied scores):

* the loss falls below 0.2 of its first value, and float AP > 0.5
  (tests/test_e2e.py);
* each int8 mode's AP50 > float AP50 - 0.02 and AP > float AP - 0.15
  (tests/test_quant.py), the int8 trees calibrated on the 8 frames
  letterboxed as serving letterboxes them.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heltondetection_tpu.models.yolov5 import YOLOv5 as JYOLOv5

from heltondetection_tpu_torch.data.augment import EvalPipeline, TrainPipeline
from heltondetection_tpu_torch.data.letterbox import letterbox_np
from heltondetection_tpu_torch.data.loader import EvalLoader, TrainLoader
from heltondetection_tpu_torch.data.readers import COCODataset
from heltondetection_tpu_torch.engine.evaluator import (Evaluator,
                                                        make_packed_serve_step)
from heltondetection_tpu_torch.models.yolov5 import YOLOv5
from heltondetection_tpu_torch.ops.quant import (quantize_yolo,
                                                 quantize_yolo_flow)
from heltondetection_tpu_torch.train.schedule import make_optimizer
from heltondetection_tpu_torch.train.trainer import (create_train_state,
                                                     make_train_step)
from heltondetection_tpu_torch.train.yolo_loss import YoloLossConfig
from heltondetection_tpu_torch.utils.cocoeval import DetEval
from heltondetection_tpu_torch.utils.convert import from_jax_variables

from synth_data import build_coco_dataset

SIZE, STEPS, BATCH = 64, 300, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One training run of the protocol: (dataset, the EMA model in eval
    mode, the first and last loss)."""
    ann, imgs = build_coco_dataset(str(tmp_path_factory.mktemp("overfit")),
                                   n_images=8, hw=(96, 128))
    ds = COCODataset(ann, imgs)
    nc = ds.num_classes
    # the reference's initial variables, as its create_train_state
    # draws them (without its optimizer state, which the port makes)
    jm = JYOLOv5(num_classes=nc, depth_multiple=0.33, width_multiple=0.125)
    init = jax.jit(functools.partial(jm.init, train=True))(
        jax.random.PRNGKey(0), jnp.zeros((BATCH, SIZE, SIZE, 3)))
    model = YOLOv5(nc, 0.33, 0.125, packed_train=True)
    model.load_state_dict(from_jax_variables(
        {"params": init["params"], "batch_stats": init["batch_stats"]}))
    state = create_train_state(model, make_optimizer(
        model, 5e-3, total_steps=STEPS, warmup_steps=20))
    step_fn = make_train_step(YoloLossConfig(num_classes=nc, img_size=SIZE))
    pipe = TrainPipeline(ds, SIZE, mosaic_p=0.0, hsv=False, flip_p=0.0,
                         max_boxes=16, seed=0)
    loader = TrainLoader(pipe, BATCH, num_workers=0, device="cpu")
    (batch,), (again,) = (list(loader.epoch(e)) for e in (0, 1))
    order = [int(np.flatnonzero([torch.equal(r, a) for r in batch["image"]])
                 [0]) for a in again["image"]]
    assert sorted(order) == list(range(BATCH))
    for k in batch:
        assert torch.equal(batch[k][order], again[k]), k
    totals = []
    for _ in range(STEPS):
        state, m = step_fn(state, batch)
        totals.append(float(m["total"]))
    ema = YOLOv5(nc, 0.33, 0.125)
    ema.load_state_dict({**model.state_dict(), **state.ema})
    return ds, ema.eval(), totals[0], totals[-1]


def test_overfit_then_int8_on_trained_weights(trained):
    """The loss falls, float AP > 0.5, and each int8 mode stays within the
    reference's AP50 and AP bars of float on the same weights."""
    ds, model, first, last = trained
    nc = ds.num_classes
    assert last < first * 0.2, (first, last)
    nb = np.zeros((0, 4), np.float32)
    pad = np.stack([letterbox_np(ds.load(k)["image"], nb, SIZE)[0]
                    for k in range(len(ds))]).astype(np.uint8)
    stats = {}
    for mode, quant in (("float", None),
                        ("layer", quantize_yolo(model, pad)),
                        ("flow", quantize_yolo_flow(model, pad))):
        step = make_packed_serve_step(model, nc, conf_thres=0.01,
                                      iou_thres=0.65, max_det=32,
                                      multi_label=False, quant=quant,
                                      device="cpu")
        det = DetEval(nc)
        ds.gt_for_eval(det)
        ev = Evaluator(None, nc, step_fn=step, device="cpu")
        stats[mode] = ev.run(EvalLoader(EvalPipeline(ds, SIZE), 4,
                                        num_workers=0), det_eval=det)
    print("trained-net AP/AP50: " + "  ".join(
        f"{m}={s['AP']:.4f}/{s['AP50']:.4f}" for m, s in stats.items()))
    assert stats["float"]["AP"] > 0.5, stats["float"]
    for mode in ("layer", "flow"):
        assert stats[mode]["AP50"] > stats["float"]["AP50"] - 0.02, \
            (mode, stats[mode])
        assert stats[mode]["AP"] > stats["float"]["AP"] - 0.15, \
            (mode, stats[mode])

"""The plain reference against the program at a tiny size on the CPU, the
program in float32: eval dets and head logits, and the training loss,
gradients and moves; and the harness's comparison, with the timed path
broken underneath, coming out not correct."""

import pytest
import torch

from benchmark.control import Altered
from benchmark.drivers import eval as ev
from benchmark.drivers import train as tr

CPU = torch.device("cpu")
SEED = 2 ** 31 + 11


def _correct(numbers, limits):
    return all(numbers[k] <= v for k, v in limits.items())


def test_yolov5_eval_dets_match_the_reference(tiny):
    c = tiny("yolov5s-coco640-eval-b32")
    n = ev.readings(c, SEED, CPU)
    # the packed head keeps its candidate rows in bfloat16
    assert n["score_gap_p50"] < 1e-3 and n["box_gap_p50"] < 1e-2, n
    assert n["dets_compared"] > 0 and n["inner_compared"] > 0
    assert n["map_off_share"] == 0.0 and n["score_off_share"] == 0.0, n
    assert n["post_gap"] == 0.0, n
    assert _correct(n, c.limits), n


def test_faster_rcnn_eval_dets_match_the_reference(tiny):
    """FasterRCNN's eval is no cell (PERF.md says why); its reference
    still holds the program's dets at a tiny size."""
    c = tiny(config="faster_rcnn_pafpn_decoupled_coco_832",
             traffic="coco-val-letterbox")
    n = ev.readings(c, SEED, CPU)
    assert n["score_gap_p90"] < 1e-3 and n["box_gap_p90"] < 1e-4, n
    assert n["recall_gap"] == 0.0 and n["dets_compared"] > 0, n


@pytest.mark.parametrize("pairing", [
    {"workload": "yolov5s-coco640-train-b64"},
    # FasterRCNN's training is no cell (PERF.md says why); its reference
    # still holds the program's step at a tiny size
    {"config": "faster_rcnn_pafpn_decoupled_coco_832",
     "traffic": "coco-train-mosaic"}])
def test_train_step_matches_the_reference(tiny, pairing):
    c = tiny(**pairing)
    n = tr.readings(c, SEED, CPU)
    assert n["loss_gap"] < 1e-4 and n["term_gap"] < 1e-4, n
    assert n["grad_gap"] < 1e-3 and n["change_gap"] < 1e-2, n
    assert _correct(n, c.limits), n


@pytest.mark.parametrize("where", ["head", "recorder"])
def test_altered_answer_is_not_correct(tiny, where):
    c = tiny("yolov5s-coco640-eval-b32")
    if where == "head":
        n = ev.readings(c, SEED, CPU, fault=c.family.alter_head)
    else:
        n = ev.readings(c, SEED, CPU, alter=Altered)
    assert not _correct(n, c.limits), n


@pytest.mark.parametrize("workload", ["yolov5s-coco640-train-b64"])
def test_half_batch_is_not_correct(tiny, workload):
    c = tiny(workload)
    c.config["train"]["batch"] = 4
    assert not _correct(tr.readings(c, SEED, CPU, fault="half"), c.limits)


@pytest.mark.parametrize("workload", ["yolov5s-coco640-train-b64"])
def test_unchanged_state_is_not_correct(tiny, workload, monkeypatch):
    c = tiny(workload)
    step = c.family.TrainProgram.step
    start = {}

    def unchanged(self, batch, draws=None):
        """The step, then the parameters and the EMA put back as they
        were: a step that returns its state unchanged."""
        model = self.state.model
        if not start:
            start.update({n: p.detach().clone()
                          for n, p in model.named_parameters()})
        metrics = step(self, batch, draws)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
                if self.state.ema is not None:
                    self.state.ema[n].copy_(start[n])
        return metrics

    monkeypatch.setattr(c.family.TrainProgram, "step", unchanged)
    assert not _correct(tr.readings(c, SEED, CPU), c.limits)

"""The port's configs, checkpoints and ``load_detector`` against the JAX
package on the CPU.

Every experiment file loads in both packages to the same
``dataclasses.asdict``. A reference variable tree carried across with
``checkpoint_from_jax_variables`` and loaded by ``load_detector(config
file, ckpt=dir, device="cpu")`` gives the dets of the reference's
``_make_detector`` on the same frames (the det multiset, at the bounds of
tests/test_torch_port_serve.py). The tiny model is a variant "t"
(depth 0.33, width 0.125) registered in both packages' ``VARIANTS`` for
the test.
"""

import dataclasses
import json
import pathlib
import textwrap

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (imported before the JAX package, as its tests do)

import heltondetection_tpu.models.cspdarknet as j_csp
from heltondetection_tpu.configs import base as j_base
from heltondetection_tpu.engine.runner import _make_detector as j_make_detector
from heltondetection_tpu.engine.runner import build_model as j_build_model

import heltondetection_tpu_torch
import heltondetection_tpu_torch.models.cspdarknet as p_csp
from heltondetection_tpu_torch import cli
from heltondetection_tpu_torch.configs import base as p_base
from heltondetection_tpu_torch.engine import runner
from heltondetection_tpu_torch.engine import serve as p_serve
from heltondetection_tpu_torch.engine.infer import Detector
from heltondetection_tpu_torch.utils import ckpt as ckpt_io
from heltondetection_tpu_torch.utils.convert import (
    checkpoint_from_jax_variables, from_jax_variables)

from test_torch_port_model import WIDTH, jax_variables
from test_torch_port_serve import (CONF, IOU, NC, SIZE, _assert_same_dets,
                                   _noise)

ROOT = pathlib.Path(__file__).resolve().parent.parent
J_CONFIGS = ROOT / "heltondetection_tpu" / "configs"
P_CONFIGS = ROOT / "heltondetection_tpu_torch" / "configs"
CONFIG_FILES = sorted(p.name for p in J_CONFIGS.glob("*.py")
                      if p.name not in ("base.py", "__init__.py"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_every_reference_config_has_a_copy():
    assert len(CONFIG_FILES) == 30
    assert sorted(p.name for p in P_CONFIGS.glob("*.py")
                  if p.name not in ("base.py", "__init__.py")) == CONFIG_FILES


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_config_loads_equal_in_both_packages(name):
    want = j_base.load_config(str(J_CONFIGS / name))
    got = p_base.load_config(str(P_CONFIGS / name))
    assert isinstance(got, p_base.ExperimentConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("ckpt_dir", "best_ckpt_dir", "log_dir"):
        assert getattr(got, prop) == getattr(want, prop)


def test_config_defaults_and_bad_file(tmp_path):
    assert dataclasses.asdict(p_base.ExperimentConfig()) == \
        dataclasses.asdict(j_base.ExperimentConfig())
    bad = tmp_path / "bad.py"
    bad.write_text("config = 3\n")
    with pytest.raises(TypeError, match="ExperimentConfig"):
        p_base.load_config(str(bad))


def test_checkpoint_roundtrip(tmp_path):
    """save → latest_step → restore: newest step by default, EMA kept
    apart, tensors back on the CPU; a missing directory raises and is not
    created."""
    d = str(tmp_path / "ckpt")
    assert ckpt_io.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt_io.restore_eval_variables(d)
    assert not (tmp_path / "ckpt").exists()
    a = {"w": torch.arange(6.0).reshape(2, 3), "n": torch.tensor(3)}
    b = {"w": torch.ones(2, 3), "n": torch.tensor(4)}
    ckpt_io.save_eval_variables(d, a, 5)
    ckpt_io.save_eval_variables(d, b, 12, ema_state=a)
    (tmp_path / "ckpt" / "junk").mkdir()
    (tmp_path / "ckpt" / "40").mkdir()           # a step that never finished
    assert ckpt_io.latest_step(d) == 12
    new = ckpt_io.restore_eval_variables(d)
    assert new["step"] == 12 and torch.equal(new["model"]["w"], b["w"])
    assert torch.equal(new["ema"]["w"], a["w"])
    old = ckpt_io.restore_eval_variables(d, step=5)
    assert old["ema"] is None and torch.equal(old["model"]["w"], a["w"])
    assert old["model"]["n"].item() == 3
    with pytest.raises(FileNotFoundError):
        ckpt_io.restore_eval_variables(d, step=6)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        ckpt_io.restore_eval_variables(str(tmp_path / "empty"))


@pytest.fixture()
def tiny_variant(monkeypatch):
    monkeypatch.setitem(j_csp.VARIANTS, "t", (0.33, WIDTH))
    monkeypatch.setitem(p_csp.VARIANTS, "t", (0.33, WIDTH))


def _write_config(tmp_path, **test_kw):
    path = tmp_path / "tiny_cfg.py"
    path.write_text(textwrap.dedent(f"""
        from heltondetection_tpu_torch.configs.base import (
            DataConfig, ExperimentConfig, ModelConfig, TestConfig)

        config = ExperimentConfig(
            name="tiny", work_dir={str(tmp_path / "runs")!r},
            data=DataConfig(class_names=("a", "b", "c", "d"),
                            val_ann="not/mounted/here.json"),
            model=ModelConfig(family="yolov5", variant="t", num_classes=80,
                              img_size={SIZE}, dtype="float32"),
            test=TestConfig(conf_thres={CONF}, iou_thres={IOU}, **{test_kw!r}))
        """))
    return str(path)


def _jax_config(tmp_path):
    return j_base.ExperimentConfig(
        name="tiny", work_dir=str(tmp_path / "runs"),
        data=j_base.DataConfig(class_names=("a", "b", "c", "d")),
        model=j_base.ModelConfig(family="yolov5", variant="t", num_classes=80,
                                 img_size=SIZE, dtype="float32"),
        test=j_base.TestConfig(conf_thres=CONF, iou_thres=IOU))


FRAMES = [((96, SIZE, 3), 21), ((SIZE, 80, 3), 22), ((SIZE, SIZE, 3), 23)]


def test_load_detector_matches_jax_make_detector(tiny_variant, tmp_path):
    """A reference checkpoint carried across, loaded from a config FILE and
    an explicit checkpoint directory: the reference's dets. Then the same
    through the work dir (``ckpt=None``, ``"last"``, ``"best"`` without a
    snapshot), the EMA weights preferred, and the overrides."""
    jmodel, variables = jax_variables(nc=NC, seed=3, head_scale=0.25)
    jcfg = _jax_config(tmp_path)
    built = j_build_model(jcfg.model, NC)
    assert (built.depth_multiple, built.width_multiple) == \
        (jmodel.depth_multiple, jmodel.width_multiple)
    frames = [_noise(shape, seed) for shape, seed in FRAMES]
    want = j_make_detector(jcfg, built, variables, NC).detect_batch(frames)

    cfg_path = _write_config(tmp_path)
    ckpt_dir = str(tmp_path / "carried")
    checkpoint_from_jax_variables(variables, ckpt_dir, step=7)
    det = heltondetection_tpu_torch.load_detector(cfg_path, ckpt=ckpt_dir,
                                                  device="cpu")
    assert isinstance(det, Detector) and not det.tta
    assert (det.num_classes, det.img_size) == (NC, SIZE)   # class_names win
    assert det.device == torch.device("cpu")
    got = det.detect_batch(frames)
    for g, w in zip(got, want):
        _assert_same_dets(g, w)

    # the work-dir routes; EMA (the real weights) preferred over raw zeros
    cfg = p_base.load_config(cfg_path)
    with pytest.raises(FileNotFoundError):
        runner.load_detector(cfg, device="cpu")
    sd = from_jax_variables(variables)
    zeros = {k: torch.zeros_like(v) for k, v in sd.items()}
    ckpt_io.save_eval_variables(cfg.ckpt_dir, zeros, 3, ema_state=sd)
    for which in (None, "last", "best"):
        again = runner.load_detector(cfg, ckpt=which, device="cpu")
        for g, h in zip(again.detect_batch(frames), got):
            for x, y in zip(g, h):
                np.testing.assert_array_equal(x, y)
    ckpt_io.save_eval_variables(cfg.best_ckpt_dir, zeros, 9)
    best = runner.load_detector(cfg, ckpt="best", device="cpu")
    assert all(len(s) == 0 for _, s, _ in best.detect_batch(frames))

    # overrides: TTA knobs reach the Detector; the unfused route builds the
    # forward_fn Detector and finds the same boxes as the port's own
    tta = runner.load_detector(cfg, ckpt=ckpt_dir, device="cpu", tta=True,
                               tta_scales=(1.0, 0.75), max_det=20)
    assert tta.tta and tta.tta_scales == (1.0, 0.75) and tta.max_det == 20
    assert len(tta.detect_image(frames[0])[1]) <= 20
    unfused_cfg = dataclasses.replace(
        cfg, eval=dataclasses.replace(cfg.eval, fused=False))
    unfused = runner.load_detector(unfused_cfg, ckpt=ckpt_dir, device="cpu")
    ub, us, uc = unfused.detect_image(frames[2])
    assert len(us) > 0 and np.isfinite(ub).all()
    # int8=True serves the quantized step, calibrated on a directory of
    # frames; the float Detector's dets stay as they were
    import cv2
    calib = tmp_path / "calib"
    calib.mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(calib / f"{i}.png"), f[..., ::-1])
    int8_cfg = dataclasses.replace(cfg, test=dataclasses.replace(
        cfg.test, int8_calib_dir=str(calib)))
    q = runner.load_detector(int8_cfg, ckpt=ckpt_dir, device="cpu",
                             int8=True)
    assert (pathlib.Path(cfg.work_dir) / cfg.name / "int8_quant.npz").exists()
    qb, qs, qc = q.detect_image(frames[2])
    assert np.isfinite(qb).all() and len(qs) == len(qc)


def test_not_ported_parts_raise_by_name(tmp_path):
    """Inference builds for both families and every registry backbone;
    training FasterRCNN and YOLOv5 over a registry backbone passes the
    train config check, more than one device (A14) still raises by name;
    an unknown family or backbone is a ValueError."""
    from heltondetection_tpu_torch.models.faster_rcnn import FasterRCNN
    mc = p_base.ModelConfig
    rcnn = runner.build_model(mc(family="faster_rcnn"), 20)
    assert isinstance(rcnn, FasterRCNN) and rcnn.cfg.backbone == "resnet50"
    swap = runner.build_model(mc(backbone="cspdarknet_l"), 20)
    assert swap.backbone_name == "cspdarknet_l"
    for change in ({"family": "faster_rcnn"}, {"backbone": "cspdarknet_l"}):
        cfg = p_base.ExperimentConfig(model=mc(**change))
        runner._check_train_config(cfg)
        cfg.train.spatial_shards = 2
        with pytest.raises(NotImplementedError, match="A14"):
            runner._check_train_config(cfg)
    with pytest.raises(ValueError, match="unknown backbone"):
        runner.build_model(mc(backbone="resnet7"), 20)
    with pytest.raises(ValueError, match="unknown model family"):
        runner.build_model(mc(family="detr"), 20)
    m = runner.build_model(mc(variant="n", dtype="bfloat16"), 7)
    assert m.num_classes == 7 and m.dtype == torch.bfloat16
    assert m.backbone.stem.conv.weight.dtype == torch.float32

    cfg = p_base.ExperimentConfig()
    assert runner._config_num_classes(cfg) == 80
    assert runner._cfg_anchors(cfg) is None
    ann = tmp_path / "val.json"
    ann.write_text(json.dumps({"images": [], "annotations": [], "categories": [
        {"id": 3, "name": "a"}, {"id": 9, "name": "b"}]}))
    cfg = dataclasses.replace(cfg, data=p_base.DataConfig(val_ann=str(ann)))
    assert runner._config_num_classes(cfg) == 2
    cfg = dataclasses.replace(cfg, data=p_base.DataConfig(
        val_ann=str(tmp_path / "not_mounted.json")))
    assert runner._config_num_classes(cfg) == 80
    cfg = dataclasses.replace(
        cfg, data=p_base.DataConfig(val_ann=str(ann), class_names=["x"] * 3),
        model=mc(anchors=[[[1, 2], [3, 4], [5, 6]]] * 3))
    assert runner._config_num_classes(cfg) == 3
    assert runner._cfg_anchors(cfg) == (((1.0, 2.0), (3.0, 4.0),
                                         (5.0, 6.0)),) * 3


def test_lazy_exports_and_cli(tiny_variant, tmp_path, monkeypatch):
    """The package exports the serving entry points lazily; the CLI serves
    a config's newest checkpoint through a BatchingDetector, and its test
    and export modes run on it (ported with run_test and engine/export.py;
    their parity is held in tests/test_torch_port_run_test.py and
    tests/test_torch_port_export.py)."""
    assert heltondetection_tpu_torch.load_detector is runner.load_detector
    assert heltondetection_tpu_torch.BatchingDetector is \
        p_serve.BatchingDetector
    assert heltondetection_tpu_torch.serve_http is p_serve.serve_http
    with pytest.raises(AttributeError):
        heltondetection_tpu_torch.no_such_name

    cfg_path = _write_config(tmp_path)
    _, variables = jax_variables(nc=NC, seed=3, head_scale=0.25)
    cfg = p_base.load_config(cfg_path)
    checkpoint_from_jax_variables(variables, cfg.ckpt_dir, step=1)
    frame = tmp_path / "frame.npy"
    np.save(frame, _noise((96, SIZE, 3), 5))
    printed = []
    with monkeypatch.context() as m:
        m.setattr("heltondetection_tpu_torch.data.readers.imread_rgb",
                  np.load)
        m.setattr("builtins.print", printed.append)
        assert cli.main(["--mode", "test", "--config", cfg_path, "--source",
                         str(frame), "--device", "cpu"]) == 0
    assert len(printed[0]["scores"]) > 0
    assert cli.main(["--mode", "export", "--config", cfg_path, "--out",
                     str(tmp_path / "m.pt2"), "--device", "cpu"]) == 0
    assert (tmp_path / "m.pt2").stat().st_size > 1000
    served = {}

    def fake_serve_http(batcher, **kw):
        served.update(kw, batch=batcher.batch_size,
                      wait=batcher.max_wait_s,
                      dets=batcher.detect(_noise((96, SIZE, 3), 5),
                                          timeout=60.0))

    monkeypatch.setattr(p_serve, "serve_http", fake_serve_http)
    assert cli.main(["--mode", "serve", "--config", cfg_path, "--device",
                     "cpu", "--port", "0", "--host", "127.0.0.1",
                     "--serve-batch", "2", "--serve-wait-ms", "3"]) == 0
    assert served["batch"] == 2 and served["wait"] == pytest.approx(3e-3)
    assert served["port"] == 0 and served["host"] == "127.0.0.1"
    assert served["class_names"] == ("a", "b", "c", "d")
    assert len(served["dets"][1]) > 0

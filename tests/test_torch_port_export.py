"""The kernels as ``torch.library`` custom ops (kernels/ops.py) and the
port's export (engine/export.py, ``cli.py --mode export``) against the JAX
package on the CPU.

* The three ops pass ``torch.library.opcheck`` (schema, autograd
  registration, the fake against the CPU implementation, AOT dispatch) on
  their CPU implementations, which equal the kernels' plain versions
  exactly, and the paths of ``ops/nms.py`` and ``ops/boxes.py`` call them.
* ``export_model`` → ``.pt2`` → ``load_serving_fn`` for both families: the
  loaded program's dets equal the eager serving function's bit for bit
  (the same ATen operations on the same inputs), its graph holds the
  ``heltondetection.nms_mask`` op (once for YOLOv5, six times for
  FasterRCNN: five RPN levels and the final NMS), and its dets are held to
  the JAX package's ``export_model`` → ``load_serving_fn`` on the same
  weights and frame: the same valid rows and classes in the same order,
  boxes within 0.1 px and scores within 4e-3 (YOLOv5) or 2e-3 px and 1e-4
  (FasterRCNN), the det tolerances the port already states
  (tests/test_torch_port_serve.py, tests/test_torch_port_rcnn_infer.py).
  The NMS predicates differ (``inter > thr·union`` here, ``inter/union >
  thr`` in the reference's XLA paths) only at exact ties, which seeded
  data does not hit.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (imported before the JAX package, as its tests do)
import jax.numpy as jnp

from heltondetection_tpu.configs import base as j_base
from heltondetection_tpu.engine.export import export_model as j_export_model
from heltondetection_tpu.engine.export import \
    load_serving_fn as j_load_serving_fn

from heltondetection_tpu_torch import cli
from heltondetection_tpu_torch.configs import base as p_base
from heltondetection_tpu_torch.engine import export as E
from heltondetection_tpu_torch.engine.export import export_serving_fn
from heltondetection_tpu_torch.kernels import launch_counts
from heltondetection_tpu_torch.kernels import ops as kernel_ops
from heltondetection_tpu_torch.models import cspdarknet as p_csp
from heltondetection_tpu_torch.ops import boxes as TB
from heltondetection_tpu_torch.ops import nms as TN
from heltondetection_tpu_torch.utils.convert import \
    checkpoint_from_jax_variables

from test_torch_port_model import WIDTH, jax_variables, port_model
from torch_rcnn_refs import SMALL_CFG, small_frame, small_rcnn

NC, SIZE = 4, 64
OPS = torch.ops.heltondetection


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _boxes(seed, b, n):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 60, (b, n, 2))
    wh = rng.uniform(4, 30, (b, n, 2))
    return torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                            .astype(np.float32))


@pytest.mark.parametrize("name", ["nms_fixpoint", "nms_mask", "iou_matrix"])
def test_ops_pass_opcheck_and_equal_plain_versions(name):
    boxes = _boxes(0, 2, 96)
    if name == "iou_matrix":
        args = (boxes[0], boxes[1, :37].contiguous())
        want = TB.box_iou_matrix(*args)
    else:
        args = (boxes, 0.5)
        plain = TN.nms_mask_seq if name == "nms_mask" else \
            TN.nms_mask_fixpoint
        want = plain(*args)
    torch.library.opcheck(getattr(OPS, name), args)
    got = getattr(OPS, name)(*args)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert 0 < int(want.sum()) < want.numel() or name == "iou_matrix"


def test_paths_call_the_ops(monkeypatch):
    """ops/nms.py's batched entries and ops/boxes.py:iou_matrix dispatch
    through the custom ops of kernels/ops.py; on CPU tensors no kernel
    launches."""
    called = []
    for name in ("nms_fixpoint", "nms_mask", "iou_matrix"):
        op = getattr(kernel_ops, name)
        monkeypatch.setattr(kernel_ops, name,
                            lambda *a, _op=op, _n=name: called.append(_n)
                            or _op(*a))
    before = dict(launch_counts)
    boxes = _boxes(1, 2, 64)
    TN.nms_mask_fixpoint_batched(boxes, 0.5)
    TN.nms_mask_batched(boxes, 0.5)
    TB.iou_matrix(boxes[0], boxes[1])
    assert called == ["nms_fixpoint", "nms_mask", "iou_matrix"]
    assert dict(launch_counts) == before


def _kernel_ops(program):
    """The custom-op targets of an exported program's graph, in order."""
    return [n.target for n in program.graph.nodes
            if str(n.target).startswith("heltondetection.")]


def _held_to_reference(got, want, box_tol, score_tol):
    """Fixed-shape dets of both packages: the same valid rows and classes
    in the same order, boxes and scores within the tolerances."""
    gb, gs, gc, gv = (t.numpy() for t in got)
    wb, ws, wc, wv = (np.asarray(t) for t in want)
    assert gb.shape == wb.shape and gs.shape == ws.shape
    np.testing.assert_array_equal(gv, wv)
    assert gv.sum() > 0
    np.testing.assert_array_equal(gc[gv], wc[wv])
    np.testing.assert_allclose(gb[gv], wb[wv], atol=box_tol, rtol=0)
    np.testing.assert_allclose(gs[gv], ws[wv], atol=score_tol, rtol=0)


def _reference_dets(tmp_path, family, jmodel, variables, x, **model_kw):
    """The dets of the JAX package's export_model of one config (conf 0.3,
    IoU 0.65), reloaded with its load_serving_fn, on ``x``."""
    jcfg = j_base.ExperimentConfig(
        model=j_base.ModelConfig(family=family, **model_kw),
        test=j_base.TestConfig(conf_thres=0.3, iou_thres=0.65))
    path = str(tmp_path / "ref.stablehlo")
    j_export_model(jcfg, jmodel, variables, path)
    return j_load_serving_fn(path)(jnp.asarray(x))


def test_export_yolov5_roundtrip_through_the_cli(tmp_path, monkeypatch):
    """``cli --mode export`` of a YOLOv5 config's checkpoint writes
    model.pt2 in the working directory (its default name); loaded, its
    dets equal the eager serving function's bit for bit and the
    reference's exported program's within the stated tolerances, and its
    graph holds one ``nms_mask`` op. With ``test.int8`` (calibrated on a
    directory of frames) it exports the quantized program: its int8
    products are ``_int_mm`` nodes beside the one ``nms_mask`` op, and
    loaded it equals the eager int8 serving function bit for bit."""
    jmodel, variables = jax_variables(nc=NC, seed=3, head_scale=0.25)
    monkeypatch.setitem(p_csp.VARIANTS, "t", (0.33, WIDTH))
    path = tmp_path / "cfg.py"
    path.write_text(
        "from heltondetection_tpu_torch.configs import base as b\n"
        f"config = b.ExperimentConfig(name='exp', work_dir="
        f"{str(tmp_path / 'runs')!r}, model=b.ModelConfig("
        f"family='yolov5', variant='t', num_classes={NC}, img_size={SIZE}, "
        f"dtype='float32'), data=b.DataConfig(class_names=('a', 'b', 'c', "
        f"'d')), test=b.TestConfig(conf_thres=0.3, iou_thres=0.65))\n")
    cfg = p_base.load_config(str(path))
    checkpoint_from_jax_variables(variables, cfg.ckpt_dir, step=1)
    x = np.random.default_rng(21).integers(0, 256, (1, SIZE, SIZE, 3)) \
        .astype(np.uint8)
    want = _reference_dets(tmp_path, "yolov5", jmodel, variables, x,
                           num_classes=NC, img_size=SIZE, dtype="float32")
    exported = []
    monkeypatch.setattr(E, "export_serving_fn", lambda *a: exported.append(
        export_serving_fn(*a)) or exported[-1])
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--mode", "export", "--config", str(path),
                     "--device", "cpu"]) == 0
    assert _kernel_ops(exported[0]) == [OPS.nms_mask.default]
    got = E.load_serving_fn(str(tmp_path / "model.pt2"))(torch.from_numpy(x))
    with torch.no_grad():
        eager = E.yolov5_serve(NC, conf_thres=0.3, iou_thres=0.65)(
            port_model(variables, NC), torch.from_numpy(x))
    for g, e in zip(got, eager):
        assert g.dtype == e.dtype and torch.equal(g, e)
    assert got[0].shape == (1, 300, 4)
    _held_to_reference(got, want, 0.1, 4e-3)
    import cv2
    from heltondetection_tpu_torch.engine.runner import _int8_quant_tree
    from heltondetection_tpu_torch.ops.quant import attach_quant
    calib = tmp_path / "calib"
    calib.mkdir()
    cv2.imwrite(str(calib / "0.png"), x[0][..., ::-1])
    cfg.test.int8, cfg.test.int8_calib_dir = True, str(calib)
    qpath = str(tmp_path / "q.pt2")
    program = E.export_model(cfg, port_model(variables, NC), qpath,
                             device="cpu")
    assert _kernel_ops(program) == [OPS.nms_mask.default]
    assert torch.ops.aten._int_mm.default in {
        n.target for n in program.graph.nodes}
    got = E.load_serving_fn(qpath)(torch.from_numpy(x))
    pm = port_model(variables, NC)
    with torch.no_grad():       # the tree from the export's cache
        eager = E.yolov5_serve(NC, conf_thres=0.3, iou_thres=0.65)(
            attach_quant(pm, _int8_quant_tree(cfg, pm)), torch.from_numpy(x))
    for g, e in zip(got, eager):
        assert g.dtype == e.dtype and torch.equal(g, e)


def test_export_faster_rcnn_roundtrip(tmp_path):
    """export_model of the small FasterRCNN: six ``nms_mask`` ops in the
    graph, the eager dets bit for bit, the reference's within the stated
    tolerances."""
    jmodel, variables, model = small_rcnn()
    x = small_frame()[None]
    # the reference in a thread: XLA's compile of it (5 s) leaves the
    # interpreter lock to the port's export meanwhile
    pool = ThreadPoolExecutor(1)
    want = pool.submit(_reference_dets, tmp_path, "faster_rcnn", jmodel,
                       variables, x, dtype="float32", **SMALL_CFG)
    pool.shutdown(wait=False)
    cfg = p_base.ExperimentConfig(
        model=p_base.ModelConfig(family="faster_rcnn", dtype="float32",
                                 **SMALL_CFG))
    path = str(tmp_path / "rcnn.pt2")
    program = E.export_model(cfg, model, path, device="cpu")
    assert _kernel_ops(program) == [OPS.nms_mask.default] * 6
    got = E.load_serving_fn(path)(torch.from_numpy(x))
    with torch.no_grad():
        eager = E.faster_rcnn_serve(model, torch.from_numpy(x))
    for g, e in zip(got, eager):
        assert g.dtype == e.dtype and torch.equal(g, e)
    _held_to_reference(got, want.result(), 2e-3, 1e-4)


def test_export_faster_rcnn_int8_roundtrip(tmp_path):
    """export_model of the small FasterRCNN with ``test.int8``
    (calibrated on a directory of frames): the quantized program, its int8
    products ``_int_mm`` nodes beside the six ``nms_mask`` ops, loaded
    equal to the eager int8 serving function bit for bit."""
    import cv2
    from heltondetection_tpu_torch.engine.runner import _int8_quant_tree
    from heltondetection_tpu_torch.ops.quant import attach_quant
    _, _, model = small_rcnn()
    x = small_frame()[None]
    calib = tmp_path / "calib"
    calib.mkdir()
    cv2.imwrite(str(calib / "0.png"), x[0][..., ::-1])
    cfg = p_base.ExperimentConfig(
        work_dir=str(tmp_path / "runs"),
        model=p_base.ModelConfig(family="faster_rcnn", dtype="float32",
                                 **SMALL_CFG),
        test=p_base.TestConfig(int8=True, int8_calib_dir=str(calib)))
    path = str(tmp_path / "rcnn_int8.pt2")
    program = E.export_model(cfg, model, path, device="cpu")
    assert _kernel_ops(program) == [OPS.nms_mask.default] * 6
    assert torch.ops.aten._int_mm.default in {
        n.target for n in program.graph.nodes}
    got = E.load_serving_fn(path)(torch.from_numpy(x))
    with torch.no_grad():       # the tree from the export's cache
        eager = E.faster_rcnn_serve(
            attach_quant(model, _int8_quant_tree(cfg, model)),
            torch.from_numpy(x))
    for g, e in zip(got, eager):
        assert g.dtype == e.dtype and torch.equal(g, e)

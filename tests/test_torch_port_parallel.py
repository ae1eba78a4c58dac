"""Data parallelism of the port on the CPU (heltondetection_tpu_torch/
parallel/mesh.py, the multi-process paths of engine/runner.py, the
``mesh`` of engine/evaluator.py, engine/infer.py and engine/serve.py,
``TrainLoader(shard=…)``, BatchNorm2d's global statistics and the
global normalizers of train/yolo_loss.py).

One module-scoped cluster of two gloo ranks (``parallel.mesh.run_ranks``,
forked from a fork server that has imported the port and the cases, never
from this process with its JAX threads; a free port, a group timeout of
60 s and a launcher timeout of 120 s that kills the ranks) runs every multi-process case of
``tests/torch_parallel_cases.py`` once, in a thread started with the
module, while this process computes the one-process answers (the same
functions, no group) and the JAX package's step; each test reads its part.
Shapes are tiny and each rank runs one thread.

Tolerances:

- two ranks against the JAX package's single-process ``make_train_step``
  on the full batch (its tiny one-level detector of the reference's own
  blocks, test_torch_port_train_step's ``JTiny``, three steps with
  clipping): each step's loss within 1e-3 absolute and the parameter
  checksum (Σ|p|) within 1e-4 relative, tests/test_multihost.py's bounds;
- two ranks against one port rank on the same global batches (that tiny
  detector, and a YOLOv5 of width 0.125 with DropBlock, the last step
  with two interleaved micro-batches): every loss term within 1e-5
  relative, the gradient norm within 1e-4 relative, the checksum within
  1e-6 relative, parameters, EMA and running statistics within 2e-4
  absolute. The ranks sum in another order, and BatchNorm computes
  E[x²] − E[x]² from the all-reduced sums where one process takes
  ``var_mean``; train-mode BatchNorm over 16 values a channel at stride
  32 (64², four images) divides those last-bit differences by each
  batch's spread, layer after layer (the gradient norm of the YOLOv5
  moves by up to 4e-5), and Adam turns a last-bit difference of a
  near-zero gradient into a step of up to the learning rate;
- BatchNorm over two ranks against ``var_mean`` of the global batch:
  outputs, statistics and gradients within 1e-5;
- the sharded eval: stats within 1e-6 of one process's, the same dets
  within 1e-4 px and score;
- the Evaluator and BatchingDetector over a two-entry CPU mesh against one
  device: dets within 1e-5.
"""

import concurrent.futures
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heltondetection_tpu.train import schedule as JS
from heltondetection_tpu.train import trainer as JT
from heltondetection_tpu.train.yolo_loss import YoloLossConfig as JLossCfg

from heltondetection_tpu_torch.data.loader import TrainLoader
from heltondetection_tpu_torch.engine import runner
from heltondetection_tpu_torch.engine.evaluator import Evaluator
from heltondetection_tpu_torch.engine.serve import BatchingDetector
from heltondetection_tpu_torch.models.common import init_weights
from heltondetection_tpu_torch.models.yolov5 import YOLOv5
from heltondetection_tpu_torch.parallel import mesh as M
from heltondetection_tpu_torch.utils.convert import from_jax_variables

import torch_parallel_cases as C
from synth_data import build_coco_dataset
from test_torch_port_train_step import JTiny, _batches, _tiny_variables

OPT = dict(total_steps=10, warmup_steps=1, weight_decay=5e-4, grad_clip=2.0,
           frozen_prefixes=("stem",))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _yolov5_sd():
    m = YOLOv5(C.NC, 0.33, 0.125, dropblock_p=0.1)
    init_weights(m, torch.Generator().manual_seed(9))
    return m.state_dict()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    # the ranks' fork server starts while the inputs are made
    warm = concurrent.futures.ThreadPoolExecutor(1)
    warm.submit(C.warm_fork_server)
    warm.shutdown(wait=False)
    root = str(tmp_path_factory.mktemp("parallel"))
    train_ann, train_imgs = build_coco_dataset(os.path.join(root, "train"),
                                               n_images=8, seed=1)
    val_ann, val_imgs = build_coco_dataset(os.path.join(root, "val"),
                                           n_images=6, seed=2)
    data = dict(train_ann=train_ann, train_imgs=train_imgs, val_ann=val_ann,
                val_imgs=val_imgs)
    variables = _tiny_variables(JTiny(C.NC))
    batches = _batches(3)
    rng = np.random.default_rng(11)
    return {
        "root": root, "variables": variables, "batches": batches,
        "tiny": dict(kind="tiny", sd=from_jax_variables(variables), opt=OPT,
                     batches=batches, accum=[1, 1, 1]),
        "yolov5": dict(kind="yolov5", sd=_yolov5_sd(), opt=OPT,
                       batches=batches, accum=[1, 1, 2]),
        "bn": dict(x=rng.normal(1.0, 2.0, (4, 6, 5, 5)).astype(np.float32),
                   w=rng.normal(0, 1, (4, 6, 5, 5)).astype(np.float32)),
        "loader": dict(n=22, batch=4),
        "data": data,
    }


def _jobs(inputs, work):
    data = inputs["data"]
    return [("tiny", "train_steps", inputs["tiny"]),
            ("yolov5", "train_steps", inputs["yolov5"]),
            ("bn", "batchnorm", inputs["bn"]),
            ("eval", "sharded_eval", dict(data, work=work + "/eval")),
            ("stop", "early_stop", dict(data, work=work + "/train")),
            ("guard", "resume_guard", dict(data, work=work + "/train"))]


@pytest.fixture(scope="module")
def cluster(inputs):
    """The two ranks' results ([rank 0's, rank 1's] {job: result}), their
    run started in a thread so that this process's own work overlaps it."""
    work = os.path.join(inputs["root"], "ranks")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(M.run_ranks, C.rank_main, 2, (_jobs(inputs, work),),
                      backend="gloo", timeout_s=120.0, group_timeout_s=60.0,
                      start_method="forkserver")
    yield fut
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def single(inputs, cluster):
    """The same jobs in this process, without a group (all but the resume
    guard, which needs two ranks)."""
    work = os.path.join(inputs["root"], "one")
    return {name: C.CASES[case](inp)
            for name, case, inp in _jobs(inputs, work) if name != "guard"}


@pytest.fixture(scope="module")
def jax_ref(inputs, cluster):
    """The reference's step (run while the ranks work)."""
    return _jax_run(inputs)


@pytest.fixture(scope="module")
def ranks(cluster, single, jax_ref):
    return cluster.result(timeout=180)


def _jax_run(inputs):
    """The reference's single-process step on the full batches: each
    step's loss and the final parameter checksum."""
    model = JTiny(C.NC)
    tx = JS.make_optimizer(1e-3, **OPT)
    variables = inputs["variables"]
    params = variables["params"]
    state = JT.TrainState(params, variables["batch_stats"], tx.init(params),
                          jnp.zeros((), jnp.int32), params)
    step = jax.jit(JT.make_train_step(model, tx, JLossCfg(num_classes=C.NC,
                                                          img_size=C.S)))
    totals = []
    for batch in inputs["batches"]:
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        totals.append(float(m["total"]))
    chk = float(sum(np.abs(np.asarray(p, np.float64)).sum()
                    for p in jax.tree_util.tree_leaves(state.params)))
    return totals, chk


def test_two_ranks_match_the_jax_single_process_step(jax_ref, ranks):
    """Two ranks of two rows each against the reference's jitted step on
    the four-row global batch: the loss of every step within 1e-3 and the
    parameter checksum within 1e-4 relative; both ranks agree exactly."""
    totals, chk = jax_ref
    r0, r1 = ranks[0]["tiny"], ranks[1]["tiny"]
    assert r0["checksum"] == r1["checksum"]
    for got, want in zip(r0["metrics"], totals):
        assert abs(got["total"] - want) < 1e-3, (got["total"], want)
    np.testing.assert_allclose(r0["checksum"], chk, rtol=1e-4)


def _close_runs(two, one):
    for got, want in zip(two["metrics"], one["metrics"]):
        for k in want:
            np.testing.assert_allclose(
                got[k], want[k], rtol=1e-4 if k == "grad_norm" else 1e-5,
                atol=1e-7, err_msg=k)
    np.testing.assert_allclose(two["checksum"], one["checksum"], rtol=1e-6)
    for k, v in one["state"].items():
        if v.is_floating_point():
            np.testing.assert_allclose(two["state"][k].numpy(), v.numpy(),
                                       atol=2e-4, err_msg=k)
    for k, v in one["ema"].items():
        np.testing.assert_allclose(two["ema"][k].numpy(), v.numpy(),
                                   atol=2e-4, err_msg=k)


@pytest.mark.parametrize("job", ["tiny", "yolov5"])
def test_two_ranks_match_one_rank(ranks, single, job):
    """The two ranks' steps against one port process on the global
    batches (YOLOv5 with DropBlock drawn for the global batch, and its
    last step with two interleaved micro-batches a rank); both ranks end
    with identical weights, EMA and running statistics."""
    r0, r1 = ranks[0][job], ranks[1][job]
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    _close_runs(r0, single[job])


def test_batchnorm_uses_the_global_batch(inputs, ranks):
    """Train-mode BatchNorm over two ranks normalizes by the global
    batch's mean and biased variance and moves the running statistics
    toward them, as one BatchNorm on the whole batch (torch's own
    ``F.batch_norm`` and ``var_mean``); the input gradients and the
    averaged weight gradient are the whole batch's."""
    x = torch.from_numpy(inputs["bn"]["x"]).requires_grad_(True)
    w = torch.from_numpy(inputs["bn"]["w"])
    c = x.shape[1]
    var, mean = torch.var_mean(x.detach(), dim=(0, 2, 3), correction=0)
    weight = torch.linspace(0.5, 1.5, c).requires_grad_(True)
    bias = torch.linspace(-0.2, 0.2, c)
    y = torch.nn.functional.batch_norm(x, None, None, weight, bias, True,
                                       0.0, 1e-3)
    (y * w).sum().backward()
    got_y = np.concatenate([r["bn"]["y"] for r in ranks])
    got_dx = np.concatenate([r["bn"]["dx"] for r in ranks])
    np.testing.assert_allclose(got_y, y.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(got_dx, x.grad.numpy(), atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["bn"]["mean"], 0.03 * mean.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(r["bn"]["var"],
                                   0.97 + 0.03 * var.numpy(), atol=1e-5)
        # the averaged gradient of the rank losses is 1/2 of the sum's
        np.testing.assert_allclose(r["bn"]["dweight"],
                                   weight.grad.numpy() / 2, atol=1e-5)


def test_train_loader_shards_partition_the_global_batch(inputs):
    """Each process's slice (``shard=(pid, 2)``, the shard ``run_train``
    passes a rank) is the contiguous half of the one-process batch of the
    same (seed, epoch): the slices are disjoint and their union, in rank
    order, is the global batch, every epoch."""
    n, bs = inputs["loader"]["n"], inputs["loader"]["batch"]
    whole = C.loader(inputs["loader"])
    halves = [C.loader(dict(inputs["loader"], shard=(pid, 2)))
              for pid in (0, 1)]
    for e in (0, 1):
        assert len(whole[e]) == n // bs
        for i, batch in enumerate(whole[e]):
            a, b = halves[0][e][i], halves[1][e][i]
            assert not set(a) & set(b)
            assert a + b == batch


def test_train_loader_refuses_an_uneven_shard():
    with pytest.raises(ValueError, match="divide"):
        TrainLoader(C._Indices(8), 3, device="cpu", shard=(0, 2))


def test_sharded_eval_matches_one_process(ranks, single):
    """``run_eval`` under two ranks (each a stride of the val set, merged
    at rank 0 through ``DetEval.add_det``) gives one process's stats on
    every rank and the same COCO results JSON."""
    one = single["eval"]
    for r in ranks:
        for k in ("AP", "AP50", "AP75", "AR100", "num_images"):
            np.testing.assert_allclose(r["eval"]["stats"][k],
                                       one["stats"][k], atol=1e-6,
                                       err_msg=k)
    assert ranks[1]["eval"]["dets"] is None   # written by rank 0 only

    def key(d):
        return (d["image_id"], d["category_id"], -d["score"])

    got = sorted(ranks[0]["eval"]["dets"], key=key)
    want = sorted(one["dets"], key=key)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a["image_id"], a["category_id"]) == \
            (b["image_id"], b["category_id"])
        np.testing.assert_allclose(a["bbox"] + [a["score"]],
                                   b["bbox"] + [b["score"]], atol=1e-4)


def test_early_stop_stops_both_ranks(ranks, single):
    """With ``patience=1`` an untrained detector stops after its second
    eval: both ranks leave the loop together, at the epoch one process
    stops at, with its best stats; only rank 0 wrote checkpoints."""
    one = single["stop"]
    assert one["evals"] == 2 and one["step"] == 4
    for r in ranks:
        assert r["stop"]["evals"] == one["evals"]
        np.testing.assert_allclose(r["stop"]["best"]["AP"],
                                   one["best"]["AP"], atol=1e-6)
    assert ranks[0]["stop"]["step"] == one["step"]


def test_resume_guard_trips_on_divergent_work_dirs(ranks):
    """Rank 0 resumes the early-stopped run's checkpoint, rank 1 finds
    none in its own work dir: both raise the resume disagreement instead
    of training from different states."""
    for r in ranks:
        assert r["guard"] is not None and \
            "resume disagreement" in r["guard"], r["guard"]


def test_init_distributed_without_markers_is_false_at_once(monkeypatch):
    for m in M.MARKERS:
        monkeypatch.delenv(m, raising=False)
    assert M.init_distributed() is False
    assert M.process_count() == 1 and M.process_index() == 0


@pytest.mark.parametrize("env,kw,match", [
    ({"WORLD_SIZE": "2", "MASTER_ADDR": "localhost", "MASTER_PORT": "1"},
     {}, "rank"),
    ({"WORLD_SIZE": "2", "RANK": "1"}, {}, "address"),
    ({"CLOUD_TPU_TASK_ID": "0"}, {}, "number of processes"),
    ({}, {"num_processes": 2, "process_id": 1}, "address"),
    ({}, {"num_processes": 2, "process_id": 1, "timeout_s": 1.0,
          "coordinator_address": "localhost:{port}"}, "could not join"),
], ids=["no-rank", "no-address", "sizeless", "args-no-address",
        "unreachable"])
def test_init_distributed_raises_when_it_cannot_join(monkeypatch, env, kw,
                                                     match):
    """Markers or arguments that ask for a cluster this process cannot
    join raise, never fall back to one process; the bootstrap has a finite
    timeout (1 s here, against a port nobody listens on)."""
    for m in M.MARKERS:
        monkeypatch.delenv(m, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if "coordinator_address" in kw:
        kw = dict(kw, coordinator_address=kw["coordinator_address"].format(
            port=M.free_port()))
    with pytest.raises((ValueError, RuntimeError), match=match):
        M.init_distributed(backend="gloo", **kw)
    assert M.process_count() == 1


def test_backend_choice_is_explicit():
    """gloo on the CPU and whenever asked for; nothing else is taken."""
    assert M.choose_backend(2) == "gloo"        # no CUDA here
    assert M.choose_backend(1, "nccl") == "nccl"
    with pytest.raises(ValueError, match="backend"):
        M.choose_backend(1, "mpi")


def _serve_model():
    m = YOLOv5(C.NC, 0.33, 0.125)
    init_weights(m, torch.Generator().manual_seed(21))
    return m.eval()


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (48 + 8 * i, C.S, 3)).astype(np.uint8)
            for i in range(n)]


def test_evaluator_over_a_cpu_mesh_matches_one_device():
    """``Evaluator(mesh=…)`` over two CPU entries, one replica each
    (``parallel.mesh.replicate``): each batch split by rows, the dets
    concatenated in batch order, equal to one device's."""
    model = _serve_model()
    mesh = M.create_mesh(2, device="cpu")
    reps = M.replicate(model, mesh)
    assert reps[0] is model and len(reps) == 2
    fwd = [runner.forward_for_eval(r, C.NC, device=d)
           for r, d in zip(reps, mesh.devices)]
    one = Evaluator(fwd[0], C.NC, device="cpu")
    two = Evaluator(fwd, C.NC, device="cpu", mesh=mesh)
    x = np.random.default_rng(3).integers(0, 256, (4, C.S, C.S, 3)
                                          ).astype(np.uint8)
    from heltondetection_tpu_torch.engine.evaluator import fetch_dets
    a = fetch_dets(one._dispatch(x))
    parts = two._dispatch(x)
    assert len(parts) == 2
    for u, v in zip(fetch_dets(parts), a):
        np.testing.assert_allclose(u, v, atol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        two._dispatch(x[:3])


@pytest.fixture(scope="module")
def mesh_detectors(tmp_path_factory):
    from heltondetection_tpu_torch.configs import base as B
    cfg = B.ExperimentConfig(model=B.ModelConfig(variant="n", img_size=C.S))
    cfg.test.conf_thres = 0.01
    mesh = M.create_mesh(2, device="cpu")
    one = runner._make_detector(cfg, _serve_model(), C.NC, device="cpu")
    two = runner._make_detector(cfg, _serve_model(), C.NC, device="cpu",
                                mesh=mesh)
    return mesh, one, two


def test_batching_detector_over_a_cpu_mesh_matches_one_device(
        mesh_detectors):
    """``load_detector``'s ``mesh`` (``_make_detector``) and
    ``BatchingDetector(mesh=…)``: every frame's dets equal the one-device
    Detector's; ``detect_batch`` over the mesh too."""
    mesh, one, two = mesh_detectors
    frames = _frames(6, 5)
    want = one.detect_batch(frames[:4])
    for (a, b, c), (u, v, w) in zip(two.detect_batch(frames[:4]), want):
        np.testing.assert_allclose(a, u, atol=1e-4)
        np.testing.assert_allclose(b, v, atol=1e-5)
        np.testing.assert_array_equal(c, w)
    with BatchingDetector(two, batch_size=4, batch_buckets=(2, 4),
                          max_wait_ms=50.0) as bd:
        assert bd.mesh is mesh
        futs = [bd.submit(f) for f in frames]
        got = [f.result(timeout=60) for f in futs]
    for f, (a, b, c) in zip(frames, got):
        u, v, w = one.detect_image(f)
        np.testing.assert_allclose(a, u, atol=1e-4)
        np.testing.assert_allclose(b, v, atol=1e-5)
        np.testing.assert_array_equal(c, w)


def test_batching_detector_raises_for_a_bucket_that_does_not_divide(
        mesh_detectors):
    """A batch size or bucket that does not divide by the mesh's devices
    raises (the reference drops such buckets silently), and a detector not
    built over the mesh is refused."""
    mesh, one, two = mesh_detectors
    with pytest.raises(ValueError, match=r"\[3\]"):
        BatchingDetector(two, batch_size=4, batch_buckets=(3,))
    with pytest.raises(ValueError, match="divide"):
        BatchingDetector(two, batch_size=5)
    with pytest.raises(ValueError, match="mesh"):
        BatchingDetector(one, batch_size=4, mesh=mesh)


def test_rank_rows_and_shard_batch():
    """A rank's rows of a global tensor (and of each field of draws); a
    batch split over a mesh; no split without a group."""
    t = torch.arange(12).reshape(6, 2)
    assert torch.equal(M.rank_rows(t, 3, 1), t[2:4])
    assert M.rank_rows((t, None), 2, 1)[1] is None
    assert M.rank_rows(t) is t
    mesh = M.create_mesh(3, device="cpu")
    parts = M.shard_batch({"image": t}, mesh)
    assert [p["image"].tolist() for p in parts] == \
        [t[0:2].tolist(), t[2:4].tolist(), t[4:6].tolist()]
    assert M.batch_sharding(mesh, 6) == [(0, 2), (2, 4), (4, 6)]
    with pytest.raises(ValueError, match="divide"):
        M.batch_sharding(mesh, 4)


def test_dryrun_programs_agree():
    """``parallel.dryrun``: the YOLOv5 and FasterRCNN train steps of a
    rank (here the one process) give finite losses, and the serve step
    and FasterRCNN inference over a two-entry CPU mesh equal one device's
    within 1e-3. Its ranks run the steps that the cluster above holds to
    one process."""
    from heltondetection_tpu_torch.parallel import dryrun as D
    steps = D._rank_steps(0, 1, "cpu")
    for name in ("yolo", "rcnn"):
        assert np.isfinite(steps[name]["total"])
    mesh = D._mesh_steps(2, "cpu")
    assert mesh["devices"] == 2
    assert mesh["yolo_serve"]["dets"] > 0 and mesh["rcnn_infer"]["dets"] > 0

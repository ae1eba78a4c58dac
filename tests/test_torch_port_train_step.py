"""Parity of the port's train step with the JAX package's on the CPU:
BatchNorm in training mode, the packed train head, the optimizer and its
schedule, the step with its EMA and gradient accumulation, multi-scale
resizing (heltondetection_tpu_torch/models, train/trainer.py,
train/schedule.py).

Weights cross through ``utils.convert`` (the optimizer's moments through
``load_adamw_state``). Tolerances, each stated where it is used:

- optimizer on given gradients: parameters within 1e-6 after three steps;
- train-mode YOLOv5 (width 0.125, 64², float32): raw maps and packed
  outputs within 5e-4 absolute and 1e-3 relative, five times the eval-mode
  tolerance of test_torch_port_model: normalizing by batch statistics
  (16 values a channel at stride 32) divides the two packages' rounding
  differences by each batch's spread, twenty times over; the weight
  blocks exactly; running statistics within 1e-4 relative;
- the step (a small one-level detector of the reference's own blocks, so
  that one compiled program stays cheap): metrics within 1e-5 relative,
  parameters, EMA and running statistics within 2e-4 after two AdamW steps
  (Adam turns a rounding difference in a near-zero gradient into a step
  of up to the learning rate's size; the learning rate here is 1e-3, so a
  few elements may differ by a fraction of it).
"""

import dataclasses
import functools

import numpy as np
import optax
import pytest
import torch
import torch.nn as tnn

import jax
import jax.numpy as jnp
from flax import linen as fnn

from heltondetection_tpu.models.common import ConvBnAct as JConvBnAct
from heltondetection_tpu.models.yolov5 import _PackedDetect
from heltondetection_tpu.train import schedule as JS
from heltondetection_tpu.train import trainer as JT
from heltondetection_tpu.train.yolo_loss import YoloLossConfig as JLossCfg

from heltondetection_tpu_torch.models.common import BatchNorm2d, ConvBnAct
from heltondetection_tpu_torch.models.yolov5 import (YOLOv5,
                                                     packed_train_head)
from heltondetection_tpu_torch.train import schedule as PS
from heltondetection_tpu_torch.train import trainer as PT
from heltondetection_tpu_torch.train.yolo_loss import \
    YoloLossConfig as PLossCfg
from heltondetection_tpu_torch.utils.convert import (from_jax_train_state,
                                                     from_jax_variables,
                                                     load_adamw_state)

from test_torch_port_model import WIDTH, jax_variables

NC, S = 3, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_batchnorm_biased_running_var():
    """Training mode moves the running variance toward the *biased* batch
    variance, as flax does (momentum 0.97, eps 1e-3); torch's own
    BatchNorm2d moves it toward the unbiased one (32 values per channel
    here: a gap of 3 % of the batch variance's step). Outputs within
    1e-5."""
    x = np.random.default_rng(0).normal(1.0, 1.5, (2, 4, 4, 3)).astype(
        np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.97,
                       epsilon=1e-3)
    v = bn.init(jax.random.PRNGKey(0), x)
    y, mut = bn.apply(v, x, mutable=["batch_stats"])
    want_var = np.asarray(mut["batch_stats"]["var"])
    biased = x.reshape(-1, 3).var(0)
    np.testing.assert_allclose(want_var, 0.97 + 0.03 * biased, rtol=1e-6)

    port = BatchNorm2d(3, eps=1e-3, momentum=0.03).train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    out = port(xt)
    np.testing.assert_allclose(port.running_var.numpy(), want_var,
                               rtol=1e-6)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y), atol=1e-5)
    plain = tnn.BatchNorm2d(3, eps=1e-3, momentum=0.03).train()
    plain(xt)
    unbiased = x.reshape(-1, 3).var(0, ddof=1)
    np.testing.assert_allclose(plain.running_var.numpy(),
                               0.97 + 0.03 * unbiased, rtol=1e-6)
    assert (np.abs(plain.running_var.numpy() / want_var - 1) > 1e-3).all()
    # bfloat16 input: statistics in float32, output in bfloat16
    port16 = BatchNorm2d(3, eps=1e-3, momentum=0.03).train()
    assert port16(xt.to(torch.bfloat16)).dtype == torch.bfloat16
    np.testing.assert_allclose(port16.running_var.numpy(),
                               port.running_var.numpy(), rtol=1e-2)


@pytest.fixture(scope="module")
def net():
    jmodel, variables = jax_variables(nc=NC, seed=0, head_scale=0.25)
    port = YOLOv5(NC, 0.33, WIDTH)
    port.load_state_dict(from_jax_variables(variables))
    return jmodel, variables, port


def test_train_mode_outputs_match_flax(net):
    """Train mode (BatchNorm on batch statistics): the standard head's raw
    maps, the packed train head's (pobj, f2, weight blocks) and the
    mutated running statistics, against flax's in one jitted program."""
    jmodel, variables, port = net
    x = np.random.default_rng(1).uniform(0, 1, (4, S, S, 3)).astype(
        np.float32)
    jp = dataclasses.replace(jmodel, packed_train=True)

    def fwd(v, x):
        # one network pass: the standard head's maps are its 1×1 conv of
        # the packed head's feature rows
        packed, mut = jp.apply(v, x, train=True, mutable=["batch_stats"])
        raw = []
        for i, (_, f2, _, (h, w)) in enumerate(packed):
            det = v["params"][f"detect{i}"]
            raw.append((f2 @ det["kernel"][0, 0] + det["bias"]).reshape(
                f2.shape[0], h, w, -1))
        return raw, [p[:3] for p in packed], mut["batch_stats"]

    raw_w, packed_w, stats_w = jax.jit(fwd)(variables, x)
    port.train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        raw_g = port(torch.from_numpy(x))
        port.load_state_dict(before)
        port.packed_train = True
        packed_g = port(torch.from_numpy(x))
    port.packed_train = False
    tol = dict(atol=5e-4, rtol=1e-3)
    for g, w in zip(raw_g, raw_w):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    for (pobj, f2, wb, hw), (jpobj, jf2, jwb) in zip(packed_g, packed_w):
        np.testing.assert_allclose(pobj.numpy(), np.asarray(jpobj), **tol)
        np.testing.assert_allclose(f2.numpy(), np.asarray(jf2), **tol)
        for (ka, ba), (jka, jba) in zip(wb, jwb):
            np.testing.assert_array_equal(ka.numpy(), np.asarray(jka))
            np.testing.assert_array_equal(ba.numpy(), np.asarray(jba))
    want = from_jax_variables({"batch_stats": stats_w})
    got = port.state_dict()
    for k, v in want.items():
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_warmup_cosine_matches_optax():
    for args in ((1e-3, 100, 10, 0.1, 0.0), (0.01, 50, 0, 0.2, 0.1),
                 (5e-4, 20, 25, 0.1, 0.0)):
        want = JS.warmup_cosine(*args)
        got = PS.warmup_cosine(*args)
        for step in (0, 1, 5, 9, 10, 11, 30, 49, 50, 80, 200):
            np.testing.assert_allclose(got(step), float(want(step)),
                                       rtol=1e-6, atol=1e-12)


class _Params(tnn.Module):
    """Named parameters of the shapes a detector has: conv kernels (decay),
    BN scales and biases (no decay), under two top-level prefixes."""

    def __init__(self, rng):
        super().__init__()
        shapes = {"backbone.stem.conv.weight": (4, 3, 3, 3),
                  "backbone.stem.bn.weight": (4,),
                  "backbone.c3.conv.weight": (6, 4, 1, 1),
                  "backbone.c3.bn.bias": (6,),
                  "neck.conv.weight": (5, 6, 3, 3),
                  "neck.bias": (5,)}
        self.names = list(shapes)
        for n, s in shapes.items():
            self.register_parameter(n.replace(".", "_"), tnn.Parameter(
                torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))))

    def named_parameters(self, *a, **k):
        for n, (_, p) in zip(self.names, super().named_parameters(*a, **k)):
            yield n, p


def _tree(named):
    """The flat names as the nested tree optax labels by path."""
    tree = {}
    for n, v in named:
        *scope, leaf = n.split(".")
        d = tree
        for k in scope:
            d = d.setdefault(k, {})
        d[leaf] = jnp.asarray(np.array(v.detach().numpy()))
    return tree


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_make_optimizer_matches_optax():
    """Three steps with clipping active (grad norms ~20 against 1.0),
    weight decay on the kernels only and a frozen prefix
    ("backbone/stem"): parameters within 1e-6 of optax's. The frozen ones
    do not move and get no moments. Then the optax state goes across
    (``load_adamw_state``) and a fourth step from it agrees too."""
    rng = np.random.default_rng(0)
    mod = _Params(rng)
    kw = dict(total_steps=10, warmup_steps=2, weight_decay=0.05,
              grad_clip=1.0, frozen_prefixes=("backbone/stem",))
    tx = JS.make_optimizer(0.1, **kw)
    opt = PS.make_optimizer(mod, 0.1, **kw)
    params = _tree(mod.named_parameters())
    state = tx.init(params)
    update = jax.jit(tx.update)
    start = dict(_flat(params))
    for step in range(4):
        grads = {n: rng.normal(0, 5, p.shape).astype(np.float32)
                 for n, p in mod.named_parameters()}
        if step == 3:            # carry optax's state across, then compare
            load_adamw_state(jax.device_get(state), opt, mod)
            with torch.no_grad():
                for n, p in mod.named_parameters():
                    p.copy_(torch.from_numpy(dict(_flat(params))[n].copy()))
        for n, p in mod.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        opt.step()
        gtree = _tree((n, torch.from_numpy(g)) for n, g in grads.items())
        updates, state = update(gtree, state, params)
        params = optax.apply_updates(params, updates)
        want = dict(_flat(params))
        for n, p in mod.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n],
                                       atol=1e-6, err_msg=f"step {step} {n}")
    for n, p in mod.named_parameters():
        moved = not np.array_equal(p.detach().numpy(), start[n])
        assert moved == (not n.startswith("backbone.stem")), n
    assert len(opt.opt.state) == 4       # no state for the frozen two


class JTiny(fnn.Module):
    """A small detector of the reference's own blocks: two ConvBnAct
    stages to stride 8 and the packed train head on that one level (the
    loss takes the levels it is given; the three-level loss is held in
    test_torch_port_train_loss.py)."""
    nc: int

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = JConvBnAct(8, 3, 4, name="stem")(x, train)
        x = JConvBnAct(12, 3, 2, name="stage")(x, train)
        b, h, w, cin = x.shape
        f2 = x.astype(jnp.float32).reshape(b, h * w, cin)
        pobj, wb = _PackedDetect(self.nc, 3, name="detect0")(f2)
        return [(pobj, f2, wb, (h, w))]


class PTiny(tnn.Module):
    def __init__(self, nc):
        super().__init__()
        self.nc = nc
        self.stem = ConvBnAct(3, 8, 3, 4)
        self.stage = ConvBnAct(8, 12, 3, 2)
        self.detect0 = tnn.Conv2d(12, 3 * (5 + nc), 1)

    def forward(self, x):
        x = self.stage(self.stem(x.permute(0, 3, 1, 2)))
        d = self.detect0
        return [packed_train_head(x, d.weight, d.bias, self.nc)]


def _batches(n, b=4, m=6, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gt = np.zeros((b, m, 4), np.float32)
        gt[..., :2] = rng.uniform(6, 58, (b, m, 2))
        gt[..., 2:] = rng.uniform(4, 40, (b, m, 2))
        out.append({"image": rng.integers(0, 256, (b, S, S, 3)).astype(
                        np.uint8),
                    "gt_boxes": gt,
                    "gt_cls": rng.integers(0, NC, (b, m)).astype(np.int32),
                    "gt_mask": rng.uniform(size=(b, m)) < 0.75})
    return out


def _tiny_variables(model):
    """Variables of ``model``'s shapes (``jax.eval_shape``: flax's own init
    would compile a program of its own), drawn from a numpy seed."""
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=True),
                            jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
    rng = np.random.default_rng(2)

    def draw(path, sd):
        name = path[-1].key
        if name == "kernel":
            x = rng.normal(0, 1 / np.sqrt(np.prod(sd.shape[:-1])), sd.shape)
        elif name in ("scale", "var"):
            x = rng.uniform(0.5, 1.5, sd.shape)
        else:
            x = rng.normal(0, 0.1, sd.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _jax_step(accum):
    model = JTiny(NC)
    variables = _tiny_variables(model)
    kw = dict(total_steps=10, warmup_steps=1, weight_decay=5e-4,
              grad_clip=2.0, frozen_prefixes=("stem",))
    tx = JS.make_optimizer(1e-3, **kw)
    step = jax.jit(JT.make_train_step(model, tx, JLossCfg(num_classes=NC,
                                                          img_size=S),
                                      accum_steps=accum))
    return variables, tx, kw, step


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    """Two steps of ``make_train_step`` (uint8 images divided inside, the
    packed loss, clipping, AdamW, a frozen prefix, the EMA), also with two
    interleaved micro-batches: metrics, parameters, running statistics and
    EMA against the reference's step."""
    variables, tx, kw, jstep = _jax_step(accum)
    params = variables["params"]
    jstate = JT.TrainState(params, variables["batch_stats"], tx.init(params),
                           jnp.zeros((), jnp.int32), params)
    model = PTiny(NC)
    model.load_state_dict(from_jax_variables(jax.device_get(variables)))
    state = PT.create_train_state(model, PS.make_optimizer(model, 1e-3, **kw))
    step = PT.make_train_step(PLossCfg(num_classes=NC, img_size=S),
                              accum_steps=accum)
    for batch in _batches(2):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
    assert state.step == int(jstate.step) == 2
    sd, ema = from_jax_train_state(jax.device_get(jstate))
    own = model.state_dict()
    for k, v in sd.items():
        if v.is_floating_point():
            np.testing.assert_allclose(own[k].numpy(), v.numpy(), atol=2e-4,
                                       rtol=1e-4, err_msg=k)
    for k, v in ema.items():
        np.testing.assert_allclose(state.ema[k].numpy(), v.numpy(),
                                   atol=2e-4, rtol=1e-4, err_msg=k)
    start = from_jax_variables(jax.device_get(variables))
    assert torch.equal(own["stem.conv.weight"], start["stem.conv.weight"])


def test_ema_decay_schedule():
    for step in (0, 1, 10, 2000, 10 ** 5):
        # the reference's float32 1 − exp(−s/τ) against float64 here
        np.testing.assert_allclose(
            PT.ema_decay_schedule(step),
            float(JT.ema_decay_schedule(jnp.asarray(step))), atol=1e-7)
    assert PT.ema_decay_schedule(0) == 0.0     # step 0 copies the params


def test_multiscale_sizes_match():
    for size, factors in ((640, (0.5, 0.75, 1.0)), (960, (0.67, 0.83, 1.0)),
                          (64, (0.1, 1.0))):
        assert PT.multiscale_sizes(size, factors) == \
            JT.multiscale_sizes(size, factors)
    for bad in ((1.5,), (0.0,), ()):
        with pytest.raises(ValueError):
            PT.multiscale_sizes(640, bad)


def test_resize_batch_to_antialias():
    """``jax.image.resize(..., "bilinear")`` antialiases when it shrinks,
    so the port resizes with ``antialias=True``: within 1e-5 of the
    reference shrinking 64 → 32 and 64 → 48 and growing 64 → 96; boxes
    scale with the image; the same size passes uint8 through untouched."""
    batch = _batches(1, b=2)[0]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for size in (32, 48, 96):
        want = JT.resize_batch_to({k: jnp.asarray(v)
                                   for k, v in batch.items()}, size)
        got = PT.resize_batch_to(tb, size)
        assert got["image"].shape == (2, size, size, 3)
        np.testing.assert_allclose(got["image"].numpy(),
                                   np.asarray(want["image"]), atol=1e-5)
        np.testing.assert_allclose(got["gt_boxes"].numpy(),
                                   np.asarray(want["gt_boxes"]), rtol=1e-6)
    plain = torch.nn.functional.interpolate(
        tb["image"].permute(0, 3, 1, 2).float() / 255.0, size=(32, 32),
        mode="bilinear", align_corners=False)
    assert float((plain.permute(0, 2, 3, 1) -
                  PT.resize_batch_to(tb, 32)["image"]).abs().max()) > 0.05
    assert PT.resize_batch_to(tb, S) is tb

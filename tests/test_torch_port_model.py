"""Parity of the port's YOLOv5 (heltondetection_tpu_torch/models) and weight
bridge with the flax model on the CPU, in float32.

One flax variable tree, its parameters drawn from a numpy seed (BatchNorm
affine terms included, so the BN mapping is tested) and its BN statistics
calibrated on noise images, drives both packages through ``utils.convert.from_jax_variables``. Raw maps match
at atol/rtol 1e-4, the tolerance of tests/test_oracle_full_network.py; the
packed head's bf16 candidate rows match within one bf16 ulp, since a float32
difference in the last bits may round either way.
"""

import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heltondetection_tpu.models.yolov5 import YOLOv5 as JYOLOv5
from heltondetection_tpu.models.yolov5 import decode_full as j_decode_full
from heltondetection_tpu.models.yolov5 import \
    pack_head_variables as j_pack_head_variables

from heltondetection_tpu_torch.models.yolov5 import (YOLOv5, build_yolov5,
                                                     calibrate_bn, decode_full,
                                                     pack_head_variables,
                                                     packed_cls_width)
from heltondetection_tpu_torch.utils.convert import from_jax_variables

NC = 6
WIDTH = 0.125


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_variables(nc=NC, seed=0, head_scale=1.0):
    """A fresh copy of :func:`_jax_variables`'s (model, variables): the
    draw and the calibration run once a process for each argument set."""
    model, variables = _jax_variables(nc, seed, head_scale)
    return model, copy.deepcopy(variables)


@functools.lru_cache(maxsize=None)
def _jax_variables(nc, seed, head_scale):
    """The tiny flax YOLOv5 and a variable tree of its shapes (from
    ``jax.eval_shape``, which skips flax's slow init). Parameters are drawn
    from a numpy seed: kernels N(0, 1/fan_in), BN scale in [0.5, 1.5] and BN
    bias N(0, 0.1²), head biases N(0, 0.5²); ``head_scale`` multiplies the
    detect kernels. The BN statistics are then calibrated on seeded noise
    images through the port (``calibrate_bn``), so activations keep O(1)
    scale at every depth instead of vanishing."""
    model = JYOLOv5(num_classes=nc, depth_multiple=0.33,
                    width_multiple=WIDTH)
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name, scope = path[-1].key, path[-2].key
        if name == "kernel":
            x = rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
            if scope.startswith("detect"):
                x = x * head_scale
        elif name in ("scale", "var"):
            x = rng.uniform(0.5, 1.5, s.shape)
        elif scope.startswith("detect"):
            x = rng.normal(0, 0.5, s.shape)
        else:
            x = rng.normal(0, 0.1, s.shape)
        return x.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    calibrated = port_model(variables, nc)
    calibrate_bn(calibrated, torch.Generator().manual_seed(seed), size=128)
    sd = calibrated.state_dict()
    stat = {"mean": "running_mean", "var": "running_var"}
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, _: sd[".".join(k.key for k in p[:-1]) + "." +
                        stat[p[-1].key]].numpy(),
        variables["batch_stats"])
    return model, variables


def jax_apply(model, variables, x):
    return jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(x))


def port_model(variables, nc=NC, packed_head=False):
    model = YOLOv5(nc, 0.33, WIDTH, packed_head=packed_head).eval()
    model.load_state_dict(from_jax_variables(variables))
    return model


def images(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    jmodel, variables = jax_variables()
    return jmodel, variables, port_model(variables)


def test_bridge_fills_every_tensor(pair):
    """The bridged state dict has exactly the port's keys and shapes (the
    strict load above would also refuse a missing or unexpected key)."""
    _, variables, model = pair
    sd = from_jax_variables(variables)
    own = model.state_dict()
    assert sd.keys() == own.keys()
    for k, v in own.items():
        assert sd[k].shape == v.shape, k
    bn = variables["batch_stats"]["backbone"]["stem"]["bn"]
    np.testing.assert_array_equal(own["backbone.stem.bn.running_var"],
                                  bn["var"])
    kern = np.asarray(variables["params"]["backbone"]["stem"]["conv"]
                      ["kernel"])
    np.testing.assert_array_equal(own["backbone.stem.conv.weight"],
                                  kern.transpose(3, 2, 0, 1))


def test_raw_maps_match_flax(pair):
    """(c) backbone → neck → head raw maps, all three levels, f32."""
    jmodel, variables, model = pair
    x = images((2, 64, 96, 3), seed=1)
    want = jax_apply(jmodel, variables, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == 3
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, lvl
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4, err_msg=f"level {lvl}")


def test_decode_full_matches_flax(pair):
    """Boxes at 0.05 px: the raw maps agree to ~1e-4 and the decode scales
    a logit error by up to 2·stride (xy) or 8·anchor·σ' (wh), tens to a few
    hundred; σ(obj) and σ(cls) at 2.5e-5, 1e-4 times σ's largest slope."""
    jmodel, variables, model = pair
    x = images((1, 64, 64, 3), seed=2)
    want = jax.jit(lambda r: j_decode_full(r, NC))(
        jax_apply(jmodel, variables, x))
    with torch.no_grad():
        got = decode_full(model(torch.from_numpy(x)), NC)
    for g, w, atol in zip(got, want, (0.05, 2.5e-5, 2.5e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


def test_pack_head_variables_matches_flax_packing(pair):
    """Packing the bridged state dict equals bridging the flax packing."""
    _, variables, model = pair
    want = from_jax_variables(j_pack_head_variables(variables, NC))
    got = pack_head_variables(model.state_dict(), NC)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)


def _within_one_bf16_ulp(a, b, atol=1e-4, rtol=1e-4):
    """|a − b| within one bf16 ulp plus the float32 tolerance: each side is
    the bf16 rounding of a float32 logit, and the two float32 logits agree
    only to the raw maps' atol/rtol. Near zero that float32 gap spans
    several bf16 ulps (a logit of 6.5e-4 has an ulp of 3.8e-6)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.float32(1e-30))
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return np.abs(a - b) <= ulp + atol + rtol * np.abs(b)


def test_packed_head_matches_flax(pair):
    """(d) per level: pobj at 1e-4, the bf16 pcand rows within one bf16 ulp
    of logits that agree at 1e-4, the anchor-major layout and the (h, w)
    entries."""
    jmodel, variables, model = pair
    x = images((2, 64, 64, 3), seed=3)
    jp = dataclasses.replace(jmodel, packed_head=True)
    want = jax_apply(jp, j_pack_head_variables(variables, NC), x)
    packed = YOLOv5(NC, 0.33, WIDTH, packed_head=True).eval()
    packed.load_state_dict(pack_head_variables(model.state_dict(), NC))
    with torch.no_grad():
        got = packed(torch.from_numpy(x))
    cp = packed_cls_width(NC)
    for (gpo, gpc, ghw), (wpo, wpc, whw) in zip(got, want):
        assert ghw == whw
        h, w = ghw
        assert gpo.shape == (2, 3 * h * w) and gpo.dtype == torch.float32
        np.testing.assert_allclose(gpo.numpy(), np.asarray(wpo), atol=1e-4,
                                   rtol=1e-4)
        assert len(gpc) == 3
        for g, wv in zip(gpc, wpc):
            assert g.shape == (2, h * w, cp) and g.dtype == torch.bfloat16
            ok = _within_one_bf16_ulp(g.float().numpy(),
                                      np.asarray(wv, np.float32))
            assert ok.all(), np.argwhere(~ok)[:5]


def test_build_yolov5_seeded_and_dtyped():
    """Random init comes from the generator alone; the compute dtype reaches
    the convs while every parameter (the conv weights too: float32 master
    weights, cast where they are used) and the head stay float32."""
    def build(seed):
        return build_yolov5("n", 3, dtype=torch.bfloat16, device="cpu",
                            generator=torch.Generator().manual_seed(seed))
    a, b, c = build(1), build(1), build(2)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["backbone.stem.conv.weight"],
                           sc["backbone.stem.conv.weight"])
    assert all(v.dtype == torch.float32 for k, v in sa.items()
               if v.is_floating_point())
    assert not a.training
    seen = []
    a.backbone.stem.bn.register_forward_hook(
        lambda m, inp, out: seen.append((inp[0].dtype, out.dtype)))
    with torch.no_grad():
        out = a(torch.from_numpy(images((1, 64, 64, 3), seed=4)))
    assert seen == [(torch.bfloat16, torch.bfloat16)]
    assert all(o.dtype == torch.float32 and torch.isfinite(o).all()
               for o in out)

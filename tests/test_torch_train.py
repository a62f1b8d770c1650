"""PyTorch port, training: the procedural scenes bit-equal to the JAX
package's; the loss, IoU and learning-rate schedule against optax and the
JAX functions; one train step of UNetSeg (widths 8, 16, 16, 16, 32x48,
batch 4) from the same JAX parameters at float32 and bfloat16; the AdamW
update against optax.adamw; the checkpoints (float16 npz and flax
msgpack) crossing both ways; and apps.train_seg on the CPU.

Tolerances, measured on the CPU (XLA:CPU against oneDNN):
  float32: loss within 1e-5 (measured 1.2e-7), every gradient within 1e-4
  of the JAX one relative by norm (measured 6.6e-5 at worst);
  bfloat16: the convs round their inputs, kernels and outputs to 8 bits
  of mantissa in another order, so loss within 5e-4 (measured 1.1e-4),
  each gradient within 0.5 relative by norm (measured 0.26 at worst, on
  the GroupNorm scale of the 4x6 bottleneck stage), all gradients
  together within 0.1 (measured 0.042) and at cosine above 0.995
  (measured 0.9991);
  AdamW: three steps of models/train.AdamW fed the JAX step's gradients
  within 1e-5 of optax.adamw's parameters (measured 6.0e-8).  The whole float32 step after
  three updates is not held to 1e-5: a gradient of ~1e-8 (near Adam's
  eps) that differs in its last bits moves its parameter by up to lr
  either way (measured 3.3e-4 on 6 of 67k parameters).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization, traverse_util

from disinfect_slam_tpu.models import segmentation as jseg
from disinfect_slam_tpu.models import synth_data as jsynth
from disinfect_slam_tpu.models import train as jtrain
from disinfect_slam_tpu_torch.apps import train_seg
from disinfect_slam_tpu_torch.io import flax_msgpack
from disinfect_slam_tpu_torch.models import segmentation as seg
from disinfect_slam_tpu_torch.models import synth_data as synth
from disinfect_slam_tpu_torch.models import train

torch.set_num_threads(1)

WIDTHS = (8, 16, 16, 16)
H, W, N = 32, 48, 4
LR = 1e-3


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _grads(model) -> dict:
    return seg.flax_from_state_dict({n: p.grad for n, p in model.named_parameters()})


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("seed,n,h,w", [(0, 2, 48, 64), (7, 3, 96, 160), (123, 2, 33, 47),
                                        (10_000, 1, 360, 640)])
def test_synthetic_batches_are_bit_equal(seed, n, h, w):
    a = synth.make_batch(np.random.default_rng(seed), n, h, w)
    b = jsynth.make_batch(np.random.default_rng(seed), n, h, w)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    img, lab = synth.make_scene(np.random.default_rng(seed + 1), h, w)
    jimg, jlab = jsynth.make_scene(np.random.default_rng(seed + 1), h, w)
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(lab, jlab)


@pytest.mark.parametrize("masked", [False, True])
def test_bce_loss_matches_optax(masked):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 8, 9, 2)) * 4).astype(np.float32)
    labels = (rng.random((3, 8, 9, 2)) > 0.4).astype(np.float32)
    mask = (rng.random((3, 8, 9)) > 0.3).astype(np.float32) if masked else None
    ref = jtrain.bce_loss(jnp.asarray(logits), jnp.asarray(labels),
                          None if mask is None else jnp.asarray(mask))
    ours = train.bce_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                          None if mask is None else torch.from_numpy(mask))
    assert abs(float(ours) - float(ref)) <= 1e-6
    if masked:  # an empty mask divides by the clamp, not by zero
        zero = torch.zeros(3, 8, 9)
        assert float(train.bce_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                    zero)) == 0.0


def test_iou_metric_equals_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 16, 20, 2)).astype(np.float32)
    labels = (rng.random((2, 16, 20, 2)) > 0.5).astype(np.float32)
    labels[..., 1] = 0.0  # a channel with an empty union on one side
    ref = np.asarray(jtrain.iou_metric(jnp.asarray(logits), jnp.asarray(labels)))
    ours = train.iou_metric(torch.from_numpy(logits), torch.from_numpy(labels)).numpy()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("steps", [60, 600, 7, 3])
def test_schedule_matches_optax_at_every_step(steps):
    """apps/train_seg.py's schedule, step by step, within one float32
    rounding (np.cos and XLA's cos differ in the last bit); the first
    update takes lr 0."""
    warm = min(50, steps // 5)
    ours = train.warmup_cosine_decay_schedule(0.0, LR, warmup_steps=warm, decay_steps=steps)
    ref = optax.warmup_cosine_decay_schedule(0.0, LR, warmup_steps=warm, decay_steps=steps)
    for i in range(steps + 2):
        np.testing.assert_allclose(ours(i), float(ref(i)), rtol=1e-6, atol=1e-12)
    assert ours(0) == (0.0 if warm else float(np.float32(LR)))


def test_schedule_drives_the_optimizer_from_lr_zero():
    """The state's schedule sets each update's lr before the step: the
    first update (lr 0) moves no parameter, the Adam moments move."""
    model = seg.create_model(widths=WIDTHS, dtype=torch.float32,
                             generator=torch.Generator().manual_seed(3))
    sched = train.warmup_cosine_decay_schedule(0.0, LR, warmup_steps=12, decay_steps=60)
    state = train.create_train_state(model, lr=sched, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = train.make_train_step(state.model, state.opt)
    imgs, labs = (torch.from_numpy(a) for a in synth.make_batch(np.random.default_rng(0), 2,
                                                                 H, W))
    state, _ = step(state, imgs, labs)
    assert state.step == 1 and state.opt.param_groups[0]["lr"] == 0.0
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    state, _ = step(state, imgs, labs)
    assert state.opt.param_groups[0]["lr"] == sched(1) > 0
    assert any(not torch.equal(v, before[k]) for k, v in model.state_dict().items())


@pytest.fixture(scope="module")
def batch():
    return jsynth.make_batch(np.random.default_rng(0), N, H, W)


def _jax_step(dtype, batch, n_steps):
    """The JAX model, its initial parameters, the loss and gradients of
    the first step, the gradients along n_steps of optax.adamw and the
    parameters after them."""
    model = jseg.create_model(widths=WIDTHS, dtype=dtype)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    imgs, labs = (jnp.asarray(a) for a in batch)

    def loss_fn(p):
        return jtrain.bce_loss(model.apply(p, imgs), labs)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    tx = optax.adamw(LR, weight_decay=1e-4)
    state = jtrain.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step = jax.jit(jtrain.make_train_step(model, tx))
    loss0, grads, trail = None, None, []
    for _ in range(n_steps):
        loss, g = grad_fn(state.params)
        trail.append(_flat(g))
        if loss0 is None:
            loss0, grads = float(loss), _flat(g)
        state, _ = step(state, imgs, labs)
    return _flat(params), loss0, grads, trail, _flat(state.params)


@pytest.fixture(scope="module")
def jax_f32(batch):
    return _jax_step(jnp.float32, batch, 3)


def _port_state(params0, dtype):
    model = seg.create_model(widths=WIDTHS, dtype=dtype)
    model.load_state_dict(seg.state_dict_from_flax(params0, model))
    return train.create_train_state(model, lr=LR, device="cpu")


def test_train_step_float32_matches_jax(jax_f32, batch):
    params0, loss0, grads, _, _ = jax_f32
    state = _port_state(params0, torch.float32)
    step = train.make_train_step(state.model, state.opt)
    state, loss = step(state, *(torch.from_numpy(a) for a in batch))
    assert abs(float(loss) - loss0) <= 1e-5
    ours = _grads(state.model)
    assert set(ours) == set(grads)
    worst = max((_rel(ours[k], grads[k]), k) for k in grads)
    assert worst[0] <= 1e-4, worst


def test_adamw_update_matches_optax(jax_f32):
    """The port's AdamW as create_train_state builds it, fed the JAX
    step's gradients, against optax.adamw's parameters after 3 steps."""
    params0, _, _, trail, params3 = jax_f32
    state = _port_state(params0, torch.float32)
    for g in trail:
        grads = seg.state_dict_from_flax(g, state.model)
        for name, p in state.model.named_parameters():
            p.grad = grads[name].clone()
        state.opt.step()
    ours = seg.flax_from_state_dict(state.model.state_dict())
    worst = max((float(np.abs(ours[k] - params3[k]).max()), k) for k in params3)
    assert worst[0] <= 1e-5, worst


def test_train_step_bfloat16_gradients_match_jax(batch):
    params0, loss0, grads, _, _ = _jax_step(jnp.bfloat16, batch, 1)
    state = _port_state(params0, torch.bfloat16)
    step = train.make_train_step(state.model, state.opt)
    state, loss = step(state, *(torch.from_numpy(a) for a in batch))
    assert abs(float(loss) - loss0) <= 5e-4
    ours = _grads(state.model)
    worst = max((_rel(ours[k], grads[k]), k) for k in grads)
    assert worst[0] <= 0.5, worst
    a = np.concatenate([ours[k].ravel() for k in sorted(grads)])
    b = np.concatenate([grads[k].ravel() for k in sorted(grads)])
    assert _rel(a, b) <= 0.1
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.995


def test_training_reduces_loss():
    """tests/test_seg_training.py's bar: 8 steps on tiny scenes cut the
    loss by 10% (bfloat16 convs, AdamW at 3e-3)."""
    imgs, labs = (torch.from_numpy(a) for a in synth.make_batch(np.random.default_rng(0), 4,
                                                                 48, 64))
    state = train.create_train_state(lr=3e-3, widths=WIDTHS, device="cpu",
                                     generator=torch.Generator().manual_seed(0))
    step = train.make_train_step(state.model, state.opt)
    losses = []
    for _ in range(8):
        state, loss = step(state, imgs, labs)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses
    m = train.make_eval_step(state.model)(imgs, labs)
    assert m["iou"].shape == (2,) and float(m["loss"]) < losses[0]


@pytest.mark.parametrize("arch", ["unet", "fast"])
def test_flax_names_round_trip(arch):
    # FastSeg's trunk width is max(widths), at least its 32 norm groups
    widths = WIDTHS if arch == "unet" else (32, 64)
    model = seg.create_model(widths=widths, arch=arch, generator=torch.Generator().manual_seed(1))
    flat = seg.flax_from_state_dict(model.state_dict())
    jmodel = jseg.create_model(widths=widths, arch=arch)
    jflat = _flat(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3))))
    assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in jflat.items()}
    back = seg.state_dict_from_flax(flat, model)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_npz_checkpoints_cross_both_ways(tmp_path):
    model = seg.create_model(widths=WIDTHS, generator=torch.Generator().manual_seed(2))
    ours = str(tmp_path / "port.npz")
    train.save_params_npz(ours, model)
    restored = _flat(jtrain.load_params_npz(ours))
    want = seg.flax_from_state_dict(model.state_dict())
    assert set(restored) == set(want)
    for k in want:
        np.testing.assert_array_equal(restored[k], want[k].astype(np.float16).astype(np.float32))

    jmodel = jseg.create_model(widths=WIDTHS)
    jparams = jmodel.init(jax.random.PRNGKey(4), jnp.zeros((1, H, W, 3)))
    theirs = str(tmp_path / "jax.npz")
    jtrain.save_params_npz(theirs, jparams)
    loaded = train.load_params_npz(theirs)
    for k, v in _flat(jparams).items():
        np.testing.assert_array_equal(loaded[k], v.astype(np.float16).astype(np.float32))
    net = seg.create_model(widths=WIDTHS)
    net.load_state_dict(seg.state_dict_from_flax(loaded, net))


def test_msgpack_checkpoints_cross_both_ways(tmp_path):
    model = seg.create_model(widths=WIDTHS, generator=torch.Generator().manual_seed(5))
    jmodel = jseg.create_model(widths=WIDTHS)
    ours = str(tmp_path / "port.msgpack")
    train.save_checkpoint(ours, model)
    restored = _flat(jtrain.load_params(ours, jmodel, h=H, w=W))
    want = seg.flax_from_state_dict(model.state_dict())
    assert set(restored) == set(want)
    for k in want:
        np.testing.assert_array_equal(restored[k], want[k])

    jparams = jmodel.init(jax.random.PRNGKey(6), jnp.zeros((1, H, W, 3)))
    theirs = str(tmp_path / "jax.msgpack")
    jtrain.save_checkpoint(theirs, jtrain.TrainState(jparams, None, None))
    loaded = train.load_params(theirs)
    jflat = _flat(jparams)
    assert set(loaded) == set(jflat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(loaded[k], v)


def test_msgpack_codec_writes_msgpack_bytes(monkeypatch):
    """The codec's bytes equal msgpack-python's for the same tree, the
    chunked form of oversized leaves included; unknown types raise."""
    rng = np.random.default_rng(0)
    tree = {"params": {"a" * 40: {"kernel": rng.standard_normal((3, 3, 3, 8)).astype(
        np.float32)}, "h": np.arange(5, dtype=np.float16), "e": np.zeros((0, 3), np.int32),
        "s": np.ones((), np.float32), "b" * 300: np.zeros(70000, np.uint8)}}
    data = flax_msgpack.pack(tree)
    # in_place keeps the tree's key order (a copy through jax.tree_map
    # would sort it); the codec writes keys in the order given
    assert data == serialization.msgpack_serialize(copy.deepcopy(tree), in_place=True)
    back = flax_msgpack.unpack(data)
    for k, v in _flat(tree).items():
        got = _flat(back)[k]
        assert got.dtype == v.dtype and got.shape == v.shape
        np.testing.assert_array_equal(got, v)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    big = {"x": np.arange(100, dtype=np.float32).reshape(4, 25)}
    data = flax_msgpack.pack(big)
    assert data == serialization.msgpack_serialize(copy.deepcopy(big), in_place=True)
    np.testing.assert_array_equal(flax_msgpack.unpack(data)["x"], big["x"])
    np.testing.assert_array_equal(serialization.msgpack_restore(data)["x"], big["x"])
    with pytest.raises(TypeError):
        flax_msgpack.pack({"f": 1.5})
    with pytest.raises(ValueError, match="ext type 2"):
        flax_msgpack.unpack(serialization.msgpack_serialize({"c": 1 + 2j}))


def test_train_seg_app_writes_a_loadable_npz(tmp_path, capsys):
    out = str(tmp_path / "nested" / "seg.npz")
    res = train_seg.main(["--device", "cpu", "--steps", "3", "--batch", "2", "--height", "32",
                          "--width", "48", "--eval-every", "2", "--out", out])
    text = capsys.readouterr().out
    for line in ("[train_seg] unet: 4.90 M params", "[train_seg] step 1/3 loss=",
                 "[train_seg] step 2/3 loss=", f"[train_seg] saved {out}"):
        assert line in text, text
    assert res["state"].step == 3 and res["iou"].shape == (2,)
    net = seg.load_model("unet", out, device="cpu")
    jparams = jtrain.load_params_npz(out)
    for k, v in seg.flax_from_state_dict(net.state_dict()).items():
        np.testing.assert_array_equal(v, _flat(jparams)[k])


def test_train_seg_out_defaults_to_the_working_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = train_seg.main(["--device", "cpu", "--steps", "1", "--batch", "1", "--height", "16",
                          "--width", "16", "--arch", "fast"])
    assert res["out"] == "seg_fast_f16.npz"
    assert os.path.exists(tmp_path / "seg_fast_f16.npz")


def test_train_state_keeps_optax_constants():
    state = train.create_train_state(widths=WIDTHS, device="cpu")
    g = state.opt.param_groups[0]
    assert (g["betas"], g["eps"], g["weight_decay"]) == ((0.9, 0.999), 1e-8, 1e-4)
    # decay reaches every parameter, GroupNorm scales and biases included
    assert len(state.opt.param_groups) == 1
    assert sum(p.numel() for p in g["params"]) == sum(
        p.numel() for p in state.model.parameters())

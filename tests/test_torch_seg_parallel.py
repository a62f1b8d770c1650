"""PyTorch port, parallel/seg_parallel.py against the JAX package's
seg_parallel (tests/test_parallel.py:83-110) on the CPU: the mesh shapes,
which parameters split, the sharded train step (1x1 bit for bit against
make_train_step; 2x2 and 4x2 against it within the stated tolerances,
AdamW held on the same gradients; 4x2 against the JAX step on conftest's
8 virtual CPU devices) and the sharded inference (1x2 and 2x2, at a height
that splits evenly and at one that does not) against the unsharded net
and the JAX one.  The nets are UNetSeg(widths=(8, 16, 32, 64)) on 32x32
images with tp_min_width=16, as in the JAX test and __graft_entry__.py;
the port's meshes are [cpu] * n."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from disinfect_slam_tpu.models import segmentation as jseg
from disinfect_slam_tpu.models.train import TrainState as JTrainState
from disinfect_slam_tpu.parallel import seg_parallel as jsp
from disinfect_slam_tpu_torch.models import segmentation as seg
from disinfect_slam_tpu_torch.models import train
from disinfect_slam_tpu_torch.parallel import seg_parallel as sp

torch.set_num_threads(1)

WIDTHS = (8, 16, 32, 64)
N, H, W = 8, 32, 32
TP = 16
LR = 1e-3


def _batch(seed=0, n=N, h=H):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, h, W, 3)).astype(np.float32),
            (rng.uniform(0, 1, (n, h, W, 2)) > 0.5).astype(np.float32))


def _mesh(n):
    return sp.make_mesh_2d(devices=["cpu"] * n)


def _flat(params) -> dict:
    return {k: np.asarray(v, np.float32)
            for k, v in traverse_util.flatten_dict(params, sep="/").items()}


@pytest.fixture(scope="module")
def jax_params():
    """The JAX net and its initial parameters as flat numpy arrays (the
    JAX steps donate their inputs: each call gets fresh arrays)."""
    model = jseg.create_model(widths=WIDTHS)
    return model, _flat(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3))))


def _tree(flat):
    return traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def _port_net(jax_params, dtype=torch.bfloat16):
    net = seg.create_model(widths=WIDTHS, dtype=dtype)
    net.load_state_dict(seg.state_dict_from_flax(jax_params[1], net))
    return net


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shapes_match_jax(n):
    assert _mesh(n).shape == jsp.make_mesh_2d(n).devices.shape
    assert sp.make_mesh_2d(n, devices=["cpu"] * 8).shape == \
        jsp.make_mesh_2d(n).devices.shape


@pytest.mark.parametrize("n", [4, 8])
def test_shard_specs_match_jax(jax_params, n):
    params = jsp.shard_params(_tree(jax_params[1]), jsp.make_mesh_2d(n), tp_min_width=TP)
    jax_split = {k: tuple(v.sharding.spec) != () and "model" in tuple(v.sharding.spec)
                 for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    net = _port_net(jax_params)
    specs = sp.shard_params(net, _mesh(n), tp_min_width=TP).specs
    ours = {}
    for name, p in net.named_parameters():
        (flax_name,) = seg.flax_from_state_dict({name: p}).keys()
        ours[flax_name] = specs[name] is not None
    assert ours == jax_split
    assert 0 < sum(ours.values()) < len(ours)


def _steps(net_state_dict, dtype, mesh, imgs, labs, n_steps):
    """n_steps of the sharded step from the given parameters: (losses,
    the gathered gradients of the first step, the gathered parameters)."""
    net = seg.create_model(widths=WIDTHS, dtype=dtype)
    net.load_state_dict(net_state_dict)
    state = sp.ShardedTrainState(sp.shard_params(net, mesh, tp_min_width=TP))
    step = sp.make_sharded_train_step(net, dict(lr=LR), mesh)
    losses, grads = [], None
    for _ in range(n_steps):
        state, loss = step(state, imgs, labs)
        losses.append(loss)
        grads = grads or state.params.full_grads()
    return losses, grads, state.params.full()


def _reference(net_state_dict, dtype, imgs, labs, n_steps):
    state = train.create_train_state(seg.create_model(widths=WIDTHS, dtype=dtype), lr=LR,
                                     device="cpu")
    state.model.load_state_dict(net_state_dict)
    step = train.make_train_step(state.model, state.opt)
    losses, grads = [], None
    for _ in range(n_steps):
        state, loss = step(state, imgs, labs)
        losses.append(loss)
        grads = grads or {k: p.grad.clone() for k, p in state.model.named_parameters()}
    return losses, grads, {k: p.detach() for k, p in state.model.named_parameters()}, state


def test_1x1_step_is_make_train_step_bit_for_bit(jax_params):
    imgs, labs = (torch.from_numpy(a) for a in _batch())
    sd = _port_net(jax_params).state_dict()
    losses, _, params = _steps(sd, torch.bfloat16, _mesh(1), imgs, labs, 2)
    ref_losses, _, ref_params, _ = _reference(sd, torch.bfloat16, imgs, labs, 2)
    for a, b in zip(losses, ref_losses):
        assert torch.equal(a, b)
    assert params.keys() == ref_params.keys()
    for k in params:
        assert torch.equal(params[k], ref_params[k]), k


# 2x2 and 4x2 against the unsharded step, float32 nets: the batch mean and
# each gradient are sums taken in another order (per data replica, then
# over the replicas), so they differ by roundings: measured loss 1.7e-7
# relative, gradients 5.4e-6 of each parameter's largest gradient.  (In
# bfloat16 the convolutions' weight gradients round per replica:
# 2.3e-2.)  Limits:
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


@pytest.mark.parametrize("n", [4, 8])
def test_sharded_step_matches_the_unsharded_step(jax_params, n):
    imgs, labs = (torch.from_numpy(a) for a in _batch())
    sd = _port_net(jax_params, torch.float32).state_dict()
    losses, grads, params = _steps(sd, torch.float32, _mesh(n), imgs, labs, 1)
    ref_losses, ref_grads, _, _ = _reference(sd, torch.float32, imgs, labs, 1)
    assert abs(float(losses[0]) - float(ref_losses[0])) <= LOSS_RTOL * float(ref_losses[0])
    for k, g in ref_grads.items():
        assert float((grads[k] - g).abs().max()) <= GRAD_RTOL * float(g.abs().max()), k
    # AdamW held on the same gradients: the unsharded optimizer given the
    # sharded step's gathered gradients makes the shards' parameters
    state = train.create_train_state(seg.create_model(widths=WIDTHS, dtype=torch.float32),
                                     lr=LR, device="cpu")
    state.model.load_state_dict(sd)
    for k, p in state.model.named_parameters():
        p.grad = grads[k].clone()
    state.opt.step()
    for k, p in state.model.named_parameters():
        assert torch.equal(p.detach(), params[k]), k


def test_sharded_step_matches_jax(jax_params):
    """The JAX sharded step on conftest's 8 virtual devices (4x2) and the
    port's over [cpu] * 8, from the same parameters, AdamW(1e-3): the two
    losses agree within 5e-4 (the bfloat16 nets' limit in
    tests/test_torch_train.py; measured 2.1e-5 and 1.1e-4) and the second
    is lower."""
    model, params = jax_params
    imgs, labs = _batch()
    mesh = jsp.make_mesh_2d(8)
    jparams = jsp.shard_params(_tree(params), mesh, tp_min_width=TP)
    tx = optax.adamw(LR)
    jstate = JTrainState(jparams, tx.init(jparams), jnp.zeros((), jnp.int32))
    jstep = jsp.make_sharded_train_step(model, tx, mesh)
    jstate, jl1 = jstep(jstate, jnp.asarray(imgs), jnp.asarray(labs))
    _, jl2 = jstep(jstate, jnp.asarray(imgs), jnp.asarray(labs))
    losses, _, _ = _steps(_port_net(jax_params).state_dict(), torch.bfloat16, _mesh(8),
                          torch.from_numpy(imgs), torch.from_numpy(labs), 2)
    assert abs(float(losses[0]) - float(jl1)) <= 5e-4
    assert abs(float(losses[1]) - float(jl2)) <= 5e-4
    assert float(losses[1]) < float(losses[0]) and float(jl2) < float(jl1)


# the sharded inference against the unsharded net: the same convolutions
# and GroupNorm statistics summed per shard, so float32 nets agree within
# 1.2e-6 (measured) and bfloat16 ones, where a rounding can flip a bf16
# activation, within 5.7e-3 of a probability (measured).  Against the JAX
# package's sharded inference (bfloat16, XLA:CPU's convolutions) the
# probabilities part by up to 0.033 (measured; bf16 roundings flipped in
# another order, as tests/test_torch_seg.py states for the logits).
INFER_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("h", [32, 48])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_infer_matches_the_net_and_jax(jax_params, n, h):
    imgs, _ = _batch(seed=3, n=4, h=h)
    x = torch.from_numpy(imgs)
    for dtype in (torch.float32, torch.bfloat16):
        net = _port_net(jax_params, dtype).eval()
        with torch.no_grad():
            full = torch.sigmoid(net(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        probs = sp.make_sharded_infer(net, _mesh(n))(x)
        assert probs.shape == (4, h, W, 2) and probs.dtype == torch.float32
        assert float((probs - full).abs().max()) <= INFER_TOL[dtype], dtype
    model, params = jax_params
    ref = np.asarray(jsp.make_sharded_infer(model, jsp.make_mesh_2d(n))(
        _tree(params), jnp.asarray(imgs)), np.float32)
    assert float(np.abs(probs.numpy() - ref).max()) <= 0.05


def test_row_split_starts_on_the_total_stride():
    assert sp.row_split(32, 2, 16) == [(0, 16), (16, 32)]
    assert sp.row_split(48, 2, 16) == [(0, 32), (32, 48)]
    assert sp.row_split(32, 4, 16) == [(0, 16), (16, 32)]
    assert sp.row_split(352, 2, 16) == [(0, 176), (176, 352)]


def test_rejects_what_it_cannot_split(jax_params):
    net = _port_net(jax_params)
    mesh = _mesh(4)
    with pytest.raises(TypeError, match="UNetSeg"):
        sp.make_sharded_infer(seg.create_model(arch="fast"), mesh)
    imgs, labs = (torch.from_numpy(a) for a in _batch(n=3))
    with pytest.raises(ValueError, match="does not split"):
        sp.make_sharded_infer(net, mesh)(imgs)
    step = sp.make_sharded_train_step(net, dict(lr=LR), mesh)
    with pytest.raises(ValueError, match="does not split"):
        step(sp.ShardedTrainState(sp.shard_params(net, mesh)), imgs, labs)
    with pytest.raises(ValueError, match="data rows"):
        sp.make_mesh_2d(devices=["cpu"] * 6, data=4)

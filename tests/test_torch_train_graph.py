"""PyTorch port, the seg net's training as captured steps on the CPU:
make_train_step / make_eval_step (models/train.py) and seg_parallel's
sharded step and inference, each through a stub capturer (a "replay" runs
the captured body again, as a CUDA graph of it would) against its eager
form (capture=False), and the captured path against the JAX package's
steps.  A narrow UNetSeg (8, 16, 16, 16) at 48x64, batch 2; the sharded
nets as in tests/test_torch_seg_parallel.py.

Tolerances: captured against eager, bit for bit (losses, parameters and
Adam moments compared as integer bits; gradients with torch.equal, since
a captured step accumulates into zeroed gradients and writes +0 where the
eager one hands on -0, which moves no parameter).  Against JAX, the
limits tests/test_torch_train.py and tests/test_torch_seg_parallel.py
state: float32 loss within 1e-5 and each gradient within 1e-4 relative by
norm; the eval step's loss within 1e-5 and its IoU equal (measured: equal);
the sharded step's losses within 5e-4 of the JAX sharded step's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from disinfect_slam_tpu.models import segmentation as jseg
from disinfect_slam_tpu.models import synth_data as jsynth
from disinfect_slam_tpu.models import train as jtrain
from disinfect_slam_tpu.models.train import TrainState as JTrainState
from disinfect_slam_tpu.parallel import seg_parallel as jsp
from disinfect_slam_tpu_torch.models import segmentation as seg
from disinfect_slam_tpu_torch.models import train
from disinfect_slam_tpu_torch.parallel import seg_parallel as sp
from disinfect_slam_tpu_torch.utils.graphs import StepGraphs

from .test_torch_graph import StubCapture

torch.set_num_threads(1)

WIDTHS = (8, 16, 16, 16)
N, H, W = 2, 48, 64
LR = 1e-3
# the sharded nets of tests/test_torch_seg_parallel.py
SP_WIDTHS, SP_N, SP_H, SP_W, SP_TP = (8, 16, 32, 64), 8, 32, 32, 16


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().view(torch.int32)


def _assert_bits(a: torch.Tensor, b: torch.Tensor, what="") -> None:
    assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape, what
    assert torch.equal(_bits(a), _bits(b)), what


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [jsynth.make_batch(rng, N, H, W) for _ in range(n)]


def _states(dtype, lr, params=None):
    """Two train states from the same parameters (seed 0, or the given
    flat flax ones)."""
    out = []
    for _ in range(2):
        model = seg.create_model(widths=WIDTHS, dtype=dtype,
                                 generator=torch.Generator().manual_seed(0))
        if params is not None:
            model.load_state_dict(seg.state_dict_from_flax(params, model))
        out.append(train.create_train_state(model, lr=lr, device="cpu"))
    return out


def _stub_step(state, capturer=None):
    stub = capturer or StubCapture()
    return train.make_train_step(state.model, state.opt,
                                 graphs=StepGraphs("cpu", capture=stub)), stub


def _as_kind(batch, kind):
    """A host batch as numpy arrays ("host": staged) or as tensors on the
    step's device ("device": copied into its buffers)."""
    return batch if kind == "host" else tuple(torch.from_numpy(a) for a in batch)


def _assert_states_equal(a, b):
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        _assert_bits(p, q, name)
        assert torch.equal(p.grad, q.grad), name
        for k in ("mu", "nu"):
            _assert_bits(a.opt.state[p][k], b.opt.state[q][k], f"{name} {k}")
    assert int(a.opt.count) == int(b.opt.count) == a.step == b.step
    _assert_bits(a.opt.lr, b.opt.lr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_captured_train_step_equals_eager_while_the_lr_moves(dtype):
    """8 steps under a warmup-cosine schedule whose lr differs at every
    step (host batches, then the same kind as tensors): the captured step
    (two staging slots of each kind captured, one replay a step after
    them) equals capture=False in every loss, parameter, gradient and Adam
    moment.  A replay that froze the capture's lr would part here."""
    sched = train.warmup_cosine_decay_schedule(0.0, 1e-2, warmup_steps=3, decay_steps=12)
    assert len({sched(i) for i in range(8)}) == 8
    cap_state, eager_state = _states(dtype, sched)
    cap, stub = _stub_step(cap_state)
    eager = train.make_train_step(eager_state.model, eager_state.opt, capture=False)
    for i, batch in enumerate(_batches(8)):
        batch = _as_kind(batch, "host" if i < 4 else "device")
        _, a = cap(cap_state, *batch)
        _, b = eager(eager_state, *batch)
        _assert_bits(a, b, f"loss {i}")
        _assert_states_equal(cap_state, eager_state)
    assert len(stub.bodies) == cap.graphs.captures == 4
    assert cap.graphs.replays == 8 - 4
    assert cap_state.opt.param_groups[0]["lr"] == sched(7)


def test_captured_eval_step_equals_eager():
    """make_eval_step captured (three calls: two staging slots, one
    replay; then tensors) against capture=False: loss and IoU bit for
    bit."""
    state, _ = _states(torch.float32, LR)
    stub = StubCapture()
    cap = train.make_eval_step(state.model, graphs=StepGraphs("cpu", capture=stub))
    eager = train.make_eval_step(state.model, capture=False)
    for i, batch in enumerate(_batches(5)):
        batch = _as_kind(batch, "host" if i < 3 else "device")
        a, b = cap(*batch), eager(*batch)
        _assert_bits(a["loss"], b["loss"])
        _assert_bits(a["iou"], b["iou"])
    assert cap.graphs.captures == 3 and cap.graphs.replays == 2


def test_two_losses_come_back_distinct_and_owner_held():
    """Each call returns its own loss tensor: a replay leaves the loss of
    an earlier call as it was, and the two steps' values differ."""
    state, _ = _states(torch.float32, LR)
    step, _ = _stub_step(state)
    batches = _batches(4)
    losses = [step(state, *b)[1] for b in batches]
    kept = [float(v) for v in losses]
    assert step.graphs.replays == 2
    assert len({v.data_ptr() for v in losses}) == 4 and len(set(kept)) == 4
    step(state, *batches[0])
    assert [float(v) for v in losses] == kept


def test_a_new_model_or_new_storage_captures_again():
    """load_state_dict copying into the parameters replays (and the replay
    reads the new values: it equals the eager twin given the same load);
    load_state_dict(assign=True), which replaces the parameters' storage,
    and a second model through the same cache each key a new capture."""
    cap_state, eager_state = _states(torch.float32, LR)
    cap, stub = _stub_step(cap_state)
    eager = train.make_train_step(eager_state.model, eager_state.opt, capture=False)
    batches = [_as_kind(b, "device") for b in _batches(6)]

    def both(batch):
        _, a = cap(cap_state, *batch)
        _, b = eager(eager_state, *batch)
        _assert_bits(a, b)

    for b in batches[:3]:
        both(b)
    assert len(stub.bodies) == 2 and cap.graphs.replays == 1
    fresh = seg.create_model(widths=WIDTHS, dtype=torch.float32,
                             generator=torch.Generator().manual_seed(5)).state_dict()
    for s in (cap_state, eager_state):
        s.model.load_state_dict(fresh)
    both(batches[3])
    assert len(stub.bodies) == 2 and cap.graphs.replays == 2
    _assert_states_equal(cap_state, eager_state)
    # new parameter tensors (the optimizer keeps updating the old ones, in
    # both twins alike): a new key
    for s in (cap_state, eager_state):
        s.model.load_state_dict({k: v.clone() for k, v in fresh.items()}, assign=True)
    both(batches[4])
    assert len(stub.bodies) == 3
    for p, q in zip(cap_state.model.parameters(), eager_state.model.parameters()):
        _assert_bits(p, q)
        assert torch.equal(p.grad, q.grad)

    other, _ = _states(torch.float32, LR)
    other_step = train.make_train_step(other.model, other.opt, graphs=cap.graphs)
    other_step(other, *batches[5])
    assert len(stub.bodies) == 4 and len(cap.graphs) == 4


def test_without_a_capturer_the_cpu_runs_the_steps_eagerly():
    """On the CPU (no capturer) the captured step's body runs every call,
    nothing is captured, and it equals capture=False."""
    cap_state, eager_state = _states(torch.float32, LR)
    cap = train.make_train_step(cap_state.model, cap_state.opt)
    eager = train.make_train_step(eager_state.model, eager_state.opt, capture=False)
    for batch in _batches(3):
        _assert_bits(cap(cap_state, *batch)[1], eager(eager_state, *batch)[1])
    assert cap.graphs.captures == 0 and cap.graphs.replays == 0
    _assert_states_equal(cap_state, eager_state)


@pytest.fixture(scope="module")
def jax_unet():
    model = jseg.create_model(widths=WIDTHS, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    return model, params, flat


def test_replayed_train_and_eval_steps_match_jax(jax_unet):
    """float32 UNet from the JAX parameters: the lr is 0 for the first two
    steps (the two staging slots' eager calls and captures), so the third
    call, a replay, runs at the initial parameters: its loss and gradients
    against the JAX step's (jax.value_and_grad of make_train_step's loss)
    within tests/test_torch_train.py's float32 limits; then make_eval_step
    of the JAX parameters, replayed, against the JAX eval step."""
    model, params, flat = jax_unet
    imgs, labs = _batches(1)[0]
    state, untouched = _states(torch.float32, lambda i: 0.0 if i < 2 else LR, params=flat)
    step, _ = _stub_step(state)
    for _ in range(3):
        state, loss = step(state, imgs, labs)
    assert step.graphs.replays == 1

    def loss_fn(p):
        return jtrain.bce_loss(model.apply(p, jnp.asarray(imgs)), jnp.asarray(labs))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    ours = seg.flax_from_state_dict({n: p.grad for n, p in state.model.named_parameters()})
    theirs = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(jgrads, sep="/").items()}
    assert set(ours) == set(theirs)
    worst = max(float(np.linalg.norm(ours[k] - g) / max(np.linalg.norm(g), 1e-30))
                for k, g in theirs.items())
    assert worst <= 1e-4, worst

    evals = train.make_eval_step(untouched.model,
                                 graphs=StepGraphs("cpu", capture=StubCapture()))
    for _ in range(3):
        m = evals(imgs, labs)
    assert evals.graphs.replays == 1
    ref = jax.jit(jtrain.make_eval_step(model))(params, jnp.asarray(imgs), jnp.asarray(labs))
    assert abs(float(m["loss"]) - float(ref["loss"])) <= 1e-5
    np.testing.assert_array_equal(m["iou"].numpy(), np.asarray(ref["iou"]))


def _sp_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.uniform(0, 1, (SP_N, SP_H, SP_W, 3)).astype(np.float32)),
             torch.from_numpy((rng.uniform(0, 1, (SP_N, SP_H, SP_W, 2)) > 0.5).astype(
                 np.float32))) for _ in range(n)]


def _sp_nets(dtype=torch.float32):
    sd = seg.create_model(widths=SP_WIDTHS, dtype=dtype,
                          generator=torch.Generator().manual_seed(1)).state_dict()
    nets = []
    for _ in range(2):
        net = seg.create_model(widths=SP_WIDTHS, dtype=dtype)
        net.load_state_dict(sd)
        nets.append(net)
    return nets


@pytest.mark.parametrize("n", [1, 4])
def test_captured_sharded_step_equals_eager(n):
    """make_sharded_train_step over [cpu] * n (1x1 and 2x2), captured
    through the stub against capture=False, 4 steps (host batches, then
    tensors: three captures, one replay): every loss, parameter and
    gradient of every shard, bit for bit."""
    mesh = sp.make_mesh_2d(devices=["cpu"] * n)
    nets = _sp_nets()
    states = [sp.ShardedTrainState(sp.shard_params(net, mesh, tp_min_width=SP_TP))
              for net in nets]
    stub = StubCapture()
    steps = [sp.make_sharded_train_step(nets[0], dict(lr=LR), mesh,
                                        graphs=StepGraphs("cpu", capture=stub)),
             sp.make_sharded_train_step(nets[1], dict(lr=LR), mesh, capture=False)]
    for i, (imgs, labs) in enumerate(_sp_batches(4)):
        if i < 2:
            imgs, labs = imgs.numpy(), labs.numpy()
        (_, a), (_, b) = (s(st, imgs, labs) for s, st in zip(steps, states))
        _assert_bits(a, b, f"loss {i}")
    assert len(stub.bodies) == 3 and steps[0].graphs.replays == 1
    full = [st.params.full() for st in states]
    grads = [st.params.full_grads() for st in states]
    for k in full[1]:
        _assert_bits(full[0][k], full[1][k], k)
        assert torch.equal(grads[0][k], grads[1][k]), k
    for a, b in zip(states[0].opts, states[1].opts):
        for x, y in zip(a, b):
            assert int(x.count) == int(y.count) == 4


@pytest.mark.parametrize("n", [2, 4])
def test_captured_sharded_infer_equals_eager(n):
    """make_sharded_infer over [cpu] * n (1x2 and 2x2), captured through
    the stub against capture=False, bfloat16 net at a height that splits
    evenly and one that does not: the probabilities bit for bit, also
    after the parameters change in place (a replay reads them where they
    live) and after load_state_dict(assign=True) (a new capture)."""
    mesh = sp.make_mesh_2d(devices=["cpu"] * n)
    net = _sp_nets(torch.bfloat16)[0].eval()
    stub = StubCapture()
    cap = sp.make_sharded_infer(net, mesh, graphs=StepGraphs("cpu", capture=stub))
    eager = sp.make_sharded_infer(net, mesh, capture=False)
    rng = np.random.default_rng(3)
    for h in (32, 48):
        imgs = rng.uniform(0, 1, (4, h, SP_W, 3)).astype(np.float32)
        for _ in range(3):
            _assert_bits(cap(imgs), eager(torch.from_numpy(imgs)))
        with torch.no_grad():
            for p in net.parameters():
                p.mul_(0.75)
        _assert_bits(cap(imgs), eager(torch.from_numpy(imgs)))
    assert len(stub.bodies) == 4 and cap.graphs.replays == 4
    net.load_state_dict({k: v.clone() for k, v in net.state_dict().items()}, assign=True)
    _assert_bits(cap(torch.from_numpy(imgs)), eager(torch.from_numpy(imgs)))
    assert len(stub.bodies) == 5


def test_captured_sharded_step_matches_jax():
    """The JAX sharded step on a 2x2 mesh of conftest's virtual devices
    and the port's captured step over [cpu] * 4 (the stub: the second
    step a replay), the same bfloat16 parameters, AdamW(1e-3): both
    losses within 5e-4 (tests/test_torch_seg_parallel.py's limit), the
    second lower."""
    model = jseg.create_model(widths=SP_WIDTHS)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, SP_H, SP_W, 3)))
    flat = {k: np.asarray(v, np.float32)
            for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    imgs, labs = (t.numpy() for t in _sp_batches(1)[0])
    jmesh = jsp.make_mesh_2d(4)
    jparams = jsp.shard_params(params, jmesh, tp_min_width=SP_TP)
    tx = optax.adamw(LR)
    jstate = JTrainState(jparams, tx.init(jparams), jnp.zeros((), jnp.int32))
    jstep = jsp.make_sharded_train_step(model, tx, jmesh)
    jlosses = []
    for _ in range(2):
        jstate, jl = jstep(jstate, jnp.asarray(imgs), jnp.asarray(labs))
        jlosses.append(float(jl))

    net = seg.create_model(widths=SP_WIDTHS)
    net.load_state_dict(seg.state_dict_from_flax(flat, net))
    mesh = sp.make_mesh_2d(devices=["cpu"] * 4)
    state = sp.ShardedTrainState(sp.shard_params(net, mesh, tp_min_width=SP_TP))
    step = sp.make_sharded_train_step(net, dict(lr=LR), mesh,
                                      graphs=StepGraphs("cpu", capture=StubCapture()))
    losses = []
    for _ in range(2):
        state, loss = step(state, torch.from_numpy(imgs), torch.from_numpy(labs))
        losses.append(float(loss))
    assert step.graphs.replays == 1
    for a, b in zip(losses, jlosses):
        assert abs(a - b) <= 5e-4, (losses, jlosses)
    assert losses[1] < losses[0] and jlosses[1] < jlosses[0]


@pytest.mark.parametrize("devices", [["cuda:0", "cuda:1"], ["cpu", "cuda:0"],
                                     ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]])
def test_a_mesh_of_distinct_devices_refuses_capture(devices):
    """A mesh of distinct devices cannot be one CUDA graph: with
    capture=True both sharded steps raise a ValueError naming
    capture=False (no silent eager run); capture=False builds them."""
    mesh = sp.make_mesh_2d(devices=devices)
    net = seg.create_model(widths=SP_WIDTHS)
    for make in (lambda c: sp.make_sharded_train_step(net, {}, mesh, capture=c),
                 lambda c: sp.make_sharded_infer(net, mesh, capture=c)):
        with pytest.raises(ValueError, match="capture=False"):
            make(True)
        assert not make(False).capture

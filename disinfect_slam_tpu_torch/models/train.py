"""Training of the ht/lt segmentation net: loss, schedule, train and eval
steps, checkpoints (counterpart of disinfect_slam_tpu/models/train.py).

The JAX package trains with optax; here the same update is written in
PyTorch idiom and held to optax's by tests/test_torch_train.py:

  - the loss is optax.sigmoid_binary_cross_entropy's formula,
    -labels * logsigmoid(x) - (1 - labels) * logsigmoid(-x), its mean (or
    the masked mean over max(mask.sum() * C, 1));
  - the optimizer is `AdamW` below, optax.adamw's update written as torch
    ops in optax's order, with its constants (b1 0.9, b2 0.999, eps 1e-8
    outside the root, weight decay 1e-4 on every parameter, GroupNorm
    scales and biases included: optax's mask is None); its count and
    learning rate live in device memory, so a captured step reads them
    there;
  - a schedule is a plain function of the step, evaluated, as optax
    does, at the count before the increment: the first update takes
    schedule(0);
  - the forward runs at the model's working dtype (bfloat16 convs on
    float32 parameters, models/segmentation.py), and the forward and
    backward run with TF32 off (`exact_fp32`), as inference does;
  - the train and eval steps are captured CUDA graphs on the card, as the
    JAX package jits them (`TrainStep`, `EvalStep`; capture=False runs
    them eagerly, the twin the captured steps are held against).

Checkpoints are the JAX package's two formats: the flat-name float16 npz
the repo ships (save_params_npz / load_params_npz) and flax's msgpack
bytes of {"params": variables} (save_checkpoint / load_params), written
and read by io/flax_msgpack.py.  Files cross both ways.

No Pallas kernel exists for any of this in the JAX package (its convs,
GroupNorm and SiLU and their gradients are XLA ops); here they are torch
ops (cuDNN convolutions and their backward on the card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..io import flax_msgpack
from ..utils.device import exact_fp32, resolve_device
from ..utils.graphs import StaticInputs, StepGraphs, batch_inputs, keep, module_key, tensors_key
# load_params_npz (flat flax names -> float32 arrays) is the inference
# module's reader, re-exported beside its writer
from .segmentation import create_model, flax_from_state_dict, load_params_npz  # noqa: F401

Schedule = Callable[[int], float]

# optax.adamw's constants and create_train_state's default lr
ADAMW_HPARAMS = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-channel binary cross entropy on channel-last [..., C] ht/lt
    maps; mask [...] weights each pixel."""
    losses = -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)
    if mask is not None:
        losses = losses * mask[..., None]
        return losses.sum() / torch.clamp(mask.sum() * logits.shape[-1], min=1.0)
    return losses.mean()


def iou_metric(logits: torch.Tensor, labels: torch.Tensor, thresh: float = 0.5) -> torch.Tensor:
    """Per-channel intersection-over-union of thresholded predictions:
    logits, labels [N, H, W, C] -> [C] in [0, 1]."""
    pred = torch.sigmoid(logits) > thresh
    lab = labels > 0.5
    inter = (pred & lab).sum(dim=(0, 1, 2)).float()
    union = (pred | lab).sum(dim=(0, 1, 2)).float()
    return inter / torch.clamp(union, min=1.0)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int) -> Schedule:
    """optax.warmup_cosine_decay_schedule (end value 0, exponent 1) as a
    function of the step: a linear ramp from init_value to peak_value
    over warmup_steps, then a cosine from peak_value to 0 over the
    remaining decay_steps - warmup_steps; computed in float32 as optax
    computes it."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError("the cosine decay needs decay_steps > warmup_steps, got "
                         f"{decay_steps=} and {warmup_steps=}")
    f32 = np.float32
    cos_steps = f32(decay_steps - warmup_steps)

    def schedule(step: int) -> float:
        if step < warmup_steps:  # never when warmup_steps <= 0: optax has no ramp then
            frac = f32(1) - f32(min(max(step, 0), warmup_steps)) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        count = min(f32(step - warmup_steps), cos_steps)
        return float(f32(peak_value) * (f32(0.5) * (f32(1) + np.cos(f32(math.pi) * count
                                                                     / cos_steps))))

    return schedule


class AdamW(torch.optim.Optimizer):
    """optax.adamw as torch ops over the parameter lists.  A step is, for
    each parameter p with a gradient g, in optax's order of operations
    (float32):

        mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  count += 1
        u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
        p = p + (-lr) (u + weight_decay p)

    The count (int32, optax's) and the learning rate (float32) are 0-d
    tensors on the parameters' device (`count`, `lr`): a captured step
    reads both from device memory, so the eager and the captured step run
    the same ops.  `set_lr` writes `lr` and the groups' "lr" (a float, for
    the reader); a captured train step stages a schedule's value into `lr`
    instead.  A parameter whose gradient is None is passed over, as
    torch's optimizers do.  The moments are made by the first step, or
    before it by `init_state`."""

    def __init__(self, params, lr: float = ADAMW_HPARAMS["lr"],
                 betas=ADAMW_HPARAMS["betas"], eps: float = ADAMW_HPARAMS["eps"],
                 weight_decay: float = ADAMW_HPARAMS["weight_decay"]):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        device = self.param_groups[0]["params"][0].device
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.lr = torch.full((), lr, dtype=torch.float32, device=device)

    def set_lr(self, lr: float) -> None:
        for group in self.param_groups:
            group["lr"] = lr
        self.lr.fill_(lr)

    def init_state(self) -> None:
        for group in self.param_groups:
            for p in group["params"]:
                if not self.state[p]:
                    self.state[p] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def tensors(self) -> list:
        """What a step writes besides the parameters: every moment, the
        count and the lr (a captured step's key holds their storage)."""
        return [t for s in self.state.values() for t in (s["mu"], s["nu"])] + [self.count,
                                                                               self.lr]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        self.init_state()
        self.count.add_(1)
        count = self.count.float()
        neg_lr = -self.lr
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            grads = [p.grad for p in params]
            mu = [self.state[p]["mu"] for p in params]
            nu = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1 - b2)
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, sq)
            u = torch._foreach_div(mu, 1 - torch.pow(b1, count))
            den = torch._foreach_div(nu, 1 - torch.pow(b2, count))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            torch._foreach_div_(u, den)
            torch._foreach_add_(u, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_mul_(u, neg_lr)
            torch._foreach_add_(params, u)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), its AdamW, the steps taken and the
    learning-rate schedule (None: the optimizer's fixed lr)."""

    model: nn.Module
    opt: AdamW
    step: int = 0
    schedule: Optional[Schedule] = None


def create_train_state(model: Optional[nn.Module] = None, lr: Union[float, Schedule] = 3e-4,
                       generator: Optional[torch.Generator] = None, arch: str = "unet",
                       widths=(32, 64, 128, 256), dtype: torch.dtype = torch.bfloat16,
                       device="cuda") -> TrainState:
    """A TrainState on `device` (CUDA unless the caller asks for another):
    `model` as given, or a new `arch` net initialised from `generator`;
    AdamW equal to optax.adamw(lr, weight_decay=1e-4), lr a float or a
    schedule of the step."""
    device = resolve_device(device)
    if model is None:
        model = create_model(widths=widths, dtype=dtype, arch=arch, generator=generator)
    model = model.to(device).train()
    schedule = lr if callable(lr) else None
    opt = AdamW(model.parameters(), **{**ADAMW_HPARAMS, "lr": schedule(0) if schedule else lr})
    return TrainState(model=model, opt=opt, step=0, schedule=schedule)


def _logits(model: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """images f32 [N, H, W, 3] -> logits f32 [N, H, W, C]."""
    return model(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _Step:
    """What the train and eval steps share: the model's device, the
    captured steps' cache (`graphs`: its `replays` count the replays), the
    static batches, the outputs the steps keep, and the staging slot."""

    def __init__(self, model: nn.Module, capture: bool, graphs: Optional[StepGraphs]):
        self.model = model
        self.device = next(model.parameters()).device
        self.capture = capture
        self.graphs = graphs if graphs is not None else StepGraphs(self.device)
        self._batches: dict = {}
        self._outputs: dict = {}
        self._tick = 0

    def _slot(self) -> int:
        self._tick += 1
        return (self._tick - 1) % 2

    def _on_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)


class TrainStep(_Step):
    """make_train_step's step: (state, images, labels) -> (state, loss),
    one AdamW step of the model in place.

    images f32 [N, H, W, 3] in [0, 1] and labels f32 [N, H, W, 2]: host
    arrays (numpy, or CPU tensors) or tensors on the model's device.  On
    a CUDA device the step is captured (utils/graphs.py), as the JAX app
    jits it: the key's first call runs eagerly, then the forward, the
    loss, the backward and AdamW are captured as one CUDA graph, which
    every later call of the key replays.  A host batch goes through pinned
    staging (two slots, used in turn; its upload is the graph's first op),
    a device batch is copied into the step's static buffers first.  The
    learning rate (the state's schedule at its step, else the group's
    "lr") goes through the same staging into the optimizer's `lr`, so a
    replay trains at this step's rate.  The key holds the batch's shapes
    and dtypes, whether it is staged, the staging slot, and the storage of
    the parameters, their gradients, the buffers and the optimizer's
    moments, count and lr: a new model, replaced parameters or new
    optimizer state capture anew.  The gradients are kept from step to
    step, zeroed and accumulated in place (not set to None), and read the
    last step's until the next.  The loss is a fresh 0-d device tensor a
    call (no host wait), valid after later calls.  On the CPU the same
    step runs eagerly.  capture=False runs the plain eager step (the
    gradients set to None and made anew by the backward): the twin the
    captured step is held against.  TF32 stays off while the step runs and
    is captured (`exact_fp32`)."""

    def __init__(self, model: nn.Module, opt: AdamW, capture: bool = True,
                 graphs: Optional[StepGraphs] = None):
        super().__init__(model, capture, graphs)
        self.opt = opt
        self._lr = StaticInputs({"lr": ((), torch.float32)}, self.device, buffers={"lr": opt.lr})

    def __call__(self, state: TrainState, images, labels):
        if state.schedule is not None:
            for group in self.opt.param_groups:
                group["lr"] = state.schedule(state.step)
        lr = self.opt.param_groups[0]["lr"]
        loss = self._captured(images, labels, lr) if self.capture else self._eager(
            self._on_device(images), self._on_device(labels), lr)
        state.step += 1
        return state, loss

    def _eager(self, images: torch.Tensor, labels: torch.Tensor, lr: float) -> torch.Tensor:
        self.opt.set_lr(lr)
        with exact_fp32():
            self.opt.zero_grad(set_to_none=True)
            loss = bce_loss(_logits(self.model, images), labels)
            loss.backward()
            self.opt.step()
        return loss.detach()

    def _captured(self, images, labels, lr: float) -> torch.Tensor:
        slot = self._slot()
        inputs, staged, key = batch_inputs(self._batches, self.device, slot, images=images,
                                           labels=labels)
        self._lr.fill(slot, lr=lr)
        params = [p for p in self.model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        self.opt.init_state()
        key = (("train", slot) + key + module_key(self.model) + tensors_key(grads)
               + tensors_key(self.opt.tensors()))

        def body():
            self._lr.upload(slot)
            if staged:
                inputs.upload(slot)
            torch._foreach_zero_(grads)
            loss = bce_loss(_logits(self.model, inputs.dev["images"]), inputs.dev["labels"])
            loss.backward()
            self.opt.step()
            keep(self._outputs, key, loss.detach())

        with exact_fp32():
            self.graphs.run(key, body)
        self._lr.done(slot)
        if staged:
            inputs.done(slot)
        return self._outputs[key][0].clone()


class EvalStep(_Step):
    """make_eval_step's step: (images, labels) -> {"loss": 0-d, "iou": [C]}
    without gradients.  Inputs, capture, keys and results as TrainStep's
    (the key holds the batch and the model's parameters and buffers; the
    results are fresh device tensors a call); capture=False runs it
    eagerly."""

    def __init__(self, model: nn.Module, capture: bool = True,
                 graphs: Optional[StepGraphs] = None):
        super().__init__(model, capture, graphs)

    def __call__(self, images, labels) -> Dict[str, torch.Tensor]:
        if not self.capture:
            images, labels = self._on_device(images), self._on_device(labels)
            with torch.no_grad(), exact_fp32():
                logits = _logits(self.model, images)
                return {"loss": bce_loss(logits, labels), "iou": iou_metric(logits, labels)}
        slot = self._slot()
        inputs, staged, key = batch_inputs(self._batches, self.device, slot, images=images,
                                           labels=labels)
        key = ("eval",) + key + module_key(self.model)

        def body():
            if staged:
                inputs.upload(slot)
            with torch.no_grad():
                logits = _logits(self.model, inputs.dev["images"])
                keep(self._outputs, key, bce_loss(logits, inputs.dev["labels"]),
                     iou_metric(logits, inputs.dev["labels"]))

        with exact_fp32():
            self.graphs.run(key, body)
        if staged:
            inputs.done(slot)
        loss, iou = (t.clone() for t in self._outputs[key])
        return {"loss": loss, "iou": iou}


def make_train_step(model: nn.Module, opt: AdamW, capture: bool = True,
                    graphs: Optional[StepGraphs] = None) -> TrainStep:
    """(state, images, labels) -> (state, loss): one AdamW step in place,
    captured on the card (TrainStep says what the key holds and how long
    each result is valid)."""
    return TrainStep(model, opt, capture, graphs)


def make_eval_step(model: nn.Module, capture: bool = True,
                   graphs: Optional[StepGraphs] = None) -> EvalStep:
    """(images, labels) -> {"loss": 0-d, "iou": [C]} without gradients,
    captured on the card (EvalStep)."""
    return EvalStep(model, capture, graphs)


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------
def _params(model_or_state) -> Dict[str, np.ndarray]:
    model = model_or_state.model if isinstance(model_or_state, TrainState) else model_or_state
    return flax_from_state_dict(model.state_dict())


def save_params_npz(path: str, model_or_state, dtype=np.float16) -> None:
    """The shippable checkpoint: the flat flax names
    ('params/ConvBlock_0/Conv_0/kernel', ...) as a compressed npz of
    float16 arrays, the JAX package's save_params_npz layout."""
    np.savez_compressed(path, **{k: v.astype(dtype) for k, v in _params(model_or_state).items()})


def save_checkpoint(path: str, model_or_state) -> None:
    """flax.serialization.to_bytes({"params": variables}) of the
    parameters in float32: the JAX package's save_checkpoint bytes."""
    tree: Dict = {}
    for name, arr in _params(model_or_state).items():
        node = tree
        *scopes, leaf = name.split("/")
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = arr
    with open(path, "wb") as f:
        f.write(flax_msgpack.pack({"params": tree}))


def load_params(path: str) -> Dict[str, np.ndarray]:
    """A save_checkpoint file (either package's) -> flat flax names ->
    float32 arrays."""
    with open(path, "rb") as f:
        tree = flax_msgpack.unpack(f.read())
    if set(tree) != {"params"}:
        raise ValueError(f"{path}: expected a {{'params': ...}} checkpoint, got keys "
                         f"{sorted(tree)}")
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v, np.float32)

    walk(tree["params"], "")
    return flat

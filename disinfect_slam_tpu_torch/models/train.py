"""Training of the ht/lt segmentation net: loss, schedule, train and eval
steps, checkpoints (counterpart of disinfect_slam_tpu/models/train.py).

The JAX package trains with optax; here the same update is written in
PyTorch idiom and held to optax's by tests/test_torch_train.py:

  - the loss is optax.sigmoid_binary_cross_entropy's formula,
    -labels * logsigmoid(x) - (1 - labels) * logsigmoid(-x), its mean (or
    the masked mean over max(mask.sum() * C, 1));
  - the optimizer is torch.optim.AdamW with optax.adamw's constants (b1
    0.9, b2 0.999, eps 1e-8 outside the root, weight decay 1e-4 on every
    parameter, GroupNorm scales and biases included: optax's mask is
    None);
  - a schedule is a plain function of the step, evaluated, as optax
    does, at the count before the increment: the first update takes
    schedule(0);
  - the forward runs at the model's working dtype (bfloat16 convs on
    float32 parameters, models/segmentation.py), and the forward and
    backward run with TF32 off (`exact_fp32`), as inference does.

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


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), its AdamW, the steps taken and the
    learning-rate schedule (None: the optimizer's fixed lr)."""

    model: nn.Module
    opt: torch.optim.AdamW
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
    opt = torch.optim.AdamW(model.parameters(), **{
        **ADAMW_HPARAMS, "lr": schedule(0) if schedule else lr})
    return TrainState(model=model, opt=opt, step=0, schedule=schedule)


def _logits(model: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """images f32 [N, H, W, 3] -> logits f32 [N, H, W, C]."""
    return model(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def make_train_step(model: nn.Module, opt: torch.optim.Optimizer):
    """(state, images, labels) -> (state, loss): one AdamW step in place.

    images: f32 [N, H, W, 3] in [0, 1]; labels: f32 [N, H, W, 2], both on
    the model's device.  The loss is a 0-d device tensor (no host wait);
    the gradients stay on the parameters until the next step."""

    def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        if state.schedule is not None:
            for group in opt.param_groups:
                group["lr"] = state.schedule(state.step)
        with exact_fp32():
            opt.zero_grad(set_to_none=True)
            loss = bce_loss(_logits(model, images), labels)
            loss.backward()
            opt.step()
        state.step += 1
        return state, loss.detach()

    return train_step


def make_eval_step(model: nn.Module):
    """(images, labels) -> {"loss": 0-d, "iou": [C]} without gradients."""

    def eval_step(images: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.no_grad(), exact_fp32():
            logits = _logits(model, images)
            return {"loss": bce_loss(logits, labels), "iou": iou_metric(logits, labels)}

    return eval_step


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

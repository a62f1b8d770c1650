"""The segmentation net over a (data, model) mesh of devices (counterpart
of disinfect_slam_tpu/parallel/seg_parallel.py):

  - training: the batch splits over `data`; the wide convolutions' output
    channels (and the GroupNorm scales and biases of the same width) split
    over `model`; gradients are summed over `data` (and, for a replicated
    parameter, over `model` too) and AdamW updates each shard;
  - inference: the batch splits over `data` and the image height over
    `model`, each model shard computing its own rows.

The JAX module annotates one program with shardings and XLA inserts the
collectives.  Here, as in parallel/sharding.py, one process drives a mesh
that is a [data, model] array of torch devices (it may repeat one:
[cuda:0] * 4 stands in for four cards), and every collective is an explicit tensor move
behind two helpers, `all_gather` and `all_sum`, which a multi-card
version can swap for NCCL's.  Autograd carries the moves backwards.

By construction each result is the unsharded net's on the whole batch;
only the order of some float32 sums differs (per-shard GroupNorm
statistics, the data replicas' losses and gradients).  On a 1x1 mesh the
train step runs the unsharded step's very ops.  TF32 stays off
(`exact_fp32`).  The nets are UNetSeg (the JAX module's type); FastSeg's
final resize mixes every row and is not split.

The JAX module jits the train step and the inference; here, on a mesh
whose devices are all one card, each is one captured CUDA graph a call
(utils/graphs.py: the replicas in turn, the collectives as moves within
the card).  A mesh of distinct cards cannot be one CUDA graph: there
capture=True raises and capture=False runs the step eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..models.segmentation import (Conv, GroupNorm, UNetSeg, _same_pads, _upsample2, group_norm,
                                   normalize)
from ..models.train import ADAMW_HPARAMS, AdamW, bce_loss
from ..utils.device import exact_fp32, resolve_device
from ..utils.graphs import StepGraphs, batch_inputs, keep, module_key, tensors_key


# ----------------------------------------------------------------------
# the mesh and the two collectives
# ----------------------------------------------------------------------
def make_mesh_2d(n_devices: Optional[int] = None, data: int = 0, devices=None) -> np.ndarray:
    """A (data, model) mesh over `devices` (the visible CUDA devices when
    None; raises without CUDA), the first n_devices of them if given: an
    object array [data, model] of torch devices, as the JAX mesh's
    `devices`.  With data <= 0 the JAX rule decides: 1x1 for one device,
    else data = max(n // 2, 1) (so 4 devices give 2x2 and 8 give 4x2) and
    model = n // data."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0:
        raise ValueError("make_mesh_2d needs at least one device")
    if data <= 0:
        # the JAX module searches a power of two and then overrides it with
        # this line; restated as it runs
        data = max(n // 2, 1) if n > 1 else 1
    if n % data:
        raise ValueError(f"{n} devices do not split into {data} data rows")
    mesh = np.empty((data, n // data), dtype=object)
    for i, d in enumerate(devs):
        mesh[i // mesh.shape[1], i % mesh.shape[1]] = d
    return mesh


def all_gather(parts: Sequence[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """All-gather along a mesh axis: each part's device gets the parts
    concatenated along `dim`, in mesh order."""
    return [torch.cat([p.to(q.device) for p in parts], dim) for q in parts]


def all_sum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-reduce along a mesh axis: each part's device gets the sum of
    the parts, added in mesh order."""
    out = []
    for q in parts:
        acc = parts[0].to(q.device)
        for p in parts[1:]:
            acc = acc + p.to(q.device)
        out.append(acc)
    return out


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------
def param_spec(p: torch.Tensor, tp_min_width: int = 64) -> Optional[int]:
    """The JAX _param_spec in torch's layouts: the dimension split over
    `model` (0: a conv kernel's output channels, or a 1-D parameter),
    or None (replicated).  A dimension splits when it is even and at
    least tp_min_width wide."""
    if p.dim() in (1, 4) and p.shape[0] % 2 == 0 and p.shape[0] >= tp_min_width:
        return 0
    return None


@dataclasses.dataclass
class ShardedParams:
    """A net's parameters over a mesh: `specs` maps each name to its split
    dimension (None: replicated); `shards[r][m]` maps each name to the
    leaf tensor on mesh[r, m] (its m-th slice, or a full copy)."""

    mesh: np.ndarray
    specs: Dict[str, Optional[int]]
    shards: List[List[Dict[str, torch.Tensor]]]

    def _full(self, field) -> Dict[str, torch.Tensor]:
        row, dev = self.shards[0], self.mesh[0, 0]
        out = {}
        for name, spec in self.specs.items():
            parts = [field(row[m][name]) for m in range(len(row))]
            out[name] = (parts[0].to(dev) if spec is None
                         else torch.cat([p.to(dev) for p in parts], spec))
        return out

    def full(self) -> Dict[str, torch.Tensor]:
        """The unsharded parameters (replica 0's, slices gathered) on the
        mesh's first device, under the net's state_dict names."""
        return self._full(lambda t: t.detach())

    def full_grads(self) -> Dict[str, torch.Tensor]:
        """The gradients of the last step, gathered as `full`."""
        return self._full(lambda t: t.grad)


def shard_params(model: nn.Module, mesh: np.ndarray, tp_min_width: int = 64) -> ShardedParams:
    """Place `model`'s parameters on the mesh: each parameter param_spec
    splits goes in `model`-axis slices, the rest is copied to every
    device; a dimension that the model axis does not divide stays
    replicated (the JAX module's ValueError fallback)."""
    n_data, n_model = mesh.shape
    specs = {}
    for name, p in model.named_parameters():
        spec = param_spec(p, tp_min_width)
        specs[name] = None if spec is not None and p.shape[spec] % n_model else spec
    shards = []
    for r in range(n_data):
        row = []
        for m in range(n_model):
            dev = mesh[r, m]
            row.append({
                name: (p.detach() if specs[name] is None
                       else p.detach().chunk(n_model, specs[name])[m]).to(dev).clone()
                .requires_grad_(True)
                for name, p in model.named_parameters()})
        shards.append(row)
    return ShardedParams(mesh, specs, shards)


# ----------------------------------------------------------------------
# training: channels over `model`
# ----------------------------------------------------------------------
def _conv_params(row, prefix: str, m: int, conv: Conv) -> Dict[str, torch.Tensor]:
    names = ["weight"] + (["bias"] if conv.bias is not None else [])
    return {k: row[m][f"{prefix}.{k}"] for k in names}


def _layer(xs, row, specs, conv: Conv, prefix: str, norm: Optional[GroupNorm] = None,
           norm_prefix: str = ""):
    """conv (-> GroupNorm -> SiLU) of the full activation xs[m] held on
    each device m of a replica row; returns the full result on each.
    A split conv computes its slice of output channels; its GroupNorm,
    of the same width and so split alike, runs on the slice where the
    slice ends on a group boundary.  The slices are gathered once, after
    the layer, or before the norm (with its scales and biases) when the
    boundary cuts a group."""
    n_model = len(xs)
    ys = [functional_call(conv, _conv_params(row, prefix, m, conv), (xs[m],))
          for m in range(n_model)]
    split = specs[f"{prefix}.weight"] is not None
    if norm is None:
        return all_gather(ys, 1) if split else ys
    scale = [row[m][f"{norm_prefix}.weight"] for m in range(n_model)]
    bias = [row[m][f"{norm_prefix}.bias"] for m in range(n_model)]
    if split and norm.groups % n_model == 0:
        return all_gather([F.silu(group_norm(ys[m], norm.groups // n_model, scale[m], bias[m],
                                             norm.dtype)) for m in range(n_model)], 1)
    if split:
        ys, scale, bias = all_gather(ys, 1), all_gather(scale, 0), all_gather(bias, 0)
    return [F.silu(group_norm(ys[m], norm.groups, scale[m], bias[m], norm.dtype))
            for m in range(n_model)]


def _unet_row(model: UNetSeg, row, specs, x: torch.Tensor, devices) -> torch.Tensor:
    """UNetSeg.forward of x [n, 3, H, W] over one replica row; returns the
    logits on the row's first device."""
    def block(i, xs):
        blk = model.blocks[i]
        return _layer(xs, row, specs, blk.conv, f"blocks.{i}.conv", blk.norm,
                      f"blocks.{i}.norm")

    xs = [x.to(d).to(model.dtype) for d in devices]
    n = len(model.widths)
    skips = []
    for i in range(n):
        xs = block(2 * i + 1, block(2 * i, xs))
        skips.append(xs)
    xs = block(2 * n + 1, block(2 * n, xs))  # bottleneck
    for j, skip in enumerate(reversed(skips)):
        up = [_upsample2(a, s) for a, s in zip(xs, skip)]
        xs = _layer(up, row, specs, model.convs[j], f"convs.{j}", model.norms[j], f"norms.{j}")
        xs = block(2 * n + 2 + j, [torch.cat([a, s], dim=1) for a, s in zip(xs, skip)])
    head = len(model.convs) - 1
    return _layer(xs, row, specs, model.convs[head], f"convs.{head}")[0]


@dataclasses.dataclass
class ShardedTrainState:
    """The sharded parameters, the steps taken and one AdamW per device
    (made by the first step: optax's tx.init)."""

    params: ShardedParams
    step: int = 0
    opts: Optional[List[List[AdamW]]] = None


def _hparams(opt_or_hparams) -> dict:
    if isinstance(opt_or_hparams, torch.optim.Optimizer):
        g = opt_or_hparams.param_groups[0]
        return {k: g[k] for k in ("lr", "betas", "eps", "weight_decay")}
    return {**ADAMW_HPARAMS, **(opt_or_hparams or {})}


def _check(model: nn.Module) -> None:
    if not isinstance(model, UNetSeg):
        raise TypeError(f"the sharded net is UNetSeg, got {type(model).__name__}")


def _one_card(mesh: np.ndarray, what: str) -> torch.device:
    """The one device of a mesh a captured step runs on (CUDA resolved:
    raises without it); a mesh of distinct devices raises ValueError."""
    def card(d):  # "cuda" is the current card
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device()
                                if torch.cuda.is_available() else 0)
        return d

    devs = {card(d) for d in mesh.flat}
    if len(devs) > 1:
        raise ValueError(f"{what}: a mesh of distinct devices {sorted(map(str, devs))} cannot "
                         f"be one CUDA graph; pass capture=False to run it eagerly")
    return resolve_device(devs.pop())


class ShardedTrainStep:
    """make_sharded_train_step's step: (state, images, labels) -> (state,
    loss), make_train_step's AdamW step over the mesh, in place on
    state.params.

    images f32 [N, H, W, 3] and labels f32 [N, H, W, 2] on any device (a
    host array too), N a multiple of the data axis; the loss is the mean
    over the whole batch, a fresh 0-d tensor a call on the mesh's first
    device, valid after later calls.  With capture=True the mesh is one
    device and the step one captured step (utils/graphs.py): the first
    call of a key runs eagerly (it makes the per-device AdamWs' moments),
    then the replicas, the moves, the gradients' sums and every shard's
    AdamW are captured as one CUDA graph, which later calls replay.  A
    host batch goes through pinned staging (two slots), a device batch is
    copied into the step's buffers first; the key holds the batch's shapes
    and dtypes, the staging slot and the storage of every leaf, its
    gradient and its AdamW's tensors (a new state captures anew).  The
    gradients are kept from step to step, zeroed, accumulated and summed
    in place, and `full_grads()` reads the last step's until the next.
    On the CPU the same step runs eagerly; capture=False runs the plain
    eager step on any mesh (gradients set to None and made anew)."""

    def __init__(self, model: UNetSeg, opt_or_hparams, mesh: np.ndarray, capture: bool = True,
                 graphs: Optional[StepGraphs] = None):
        _check(model)
        self.model, self.mesh, self.capture = model, mesh, capture
        self.hp = _hparams(opt_or_hparams)
        if capture:
            self.device = _one_card(mesh, "make_sharded_train_step")
            self.graphs = graphs if graphs is not None else StepGraphs(self.device)
        self._batches: dict = {}
        self._outputs: dict = {}
        self._tick = 0

    def _loss(self, params: ShardedParams, images: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
        n_data = self.mesh.shape[0]
        dev0 = self.mesh[0, 0]
        b = images.shape[0] // n_data
        loss = None
        for r in range(n_data):
            devs = self.mesh[r]
            logits = _unet_row(self.model, params.shards[r], params.specs,
                               images[r * b:(r + 1) * b].permute(0, 3, 1, 2), devs)
            # the batch mean, entered once per data replica
            part = bce_loss(logits.permute(0, 2, 3, 1),
                            labels[r * b:(r + 1) * b].to(devs[0])) / n_data
            loss = part.to(dev0) if loss is None else loss + part.to(dev0)
        return loss

    def __call__(self, state: ShardedTrainState, images, labels):
        params = state.params
        n_data = self.mesh.shape[0]
        if images.shape[0] % n_data:
            raise ValueError(f"batch {images.shape[0]} does not split over {n_data} data rows")
        if state.opts is None:
            state.opts = [[AdamW(list(leaves.values()), **self.hp) for leaves in row]
                          for row in params.shards]
        opts = [opt for row in state.opts for opt in row]
        leaves = [t for row in params.shards for ls in row for t in ls.values()]
        if not self.capture:
            images, labels = torch.as_tensor(images), torch.as_tensor(labels)
            with exact_fp32():
                for t in leaves:
                    t.grad = None
                loss = self._loss(params, images, labels)
                loss.backward()
                _sum_grads(params)
                for opt in opts:
                    opt.step()
            state.step += 1
            return state, loss.detach()

        slot = self._tick % 2
        self._tick += 1
        inputs, staged, key = batch_inputs(self._batches, self.device, slot, images=images,
                                           labels=labels)
        for t in leaves:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        grads = [t.grad for t in leaves]
        for opt in opts:
            opt.init_state()
        key = (("sharded_train",) + key + tensors_key(leaves) + tensors_key(grads)
               + tensors_key(t for opt in opts for t in opt.tensors()))

        def body():
            if staged:
                inputs.upload(slot)
            torch._foreach_zero_(grads)
            loss = self._loss(params, inputs.dev["images"], inputs.dev["labels"])
            loss.backward()
            _sum_grads(params, in_place=True)
            for opt in opts:
                opt.step()
            keep(self._outputs, key, loss.detach())

        with exact_fp32():
            self.graphs.run(key, body)
        if staged:
            inputs.done(slot)
        state.step += 1
        return state, self._outputs[key][0].clone()


def make_sharded_train_step(model: UNetSeg, opt_or_hparams, mesh: np.ndarray,
                            capture: bool = True,
                            graphs: Optional[StepGraphs] = None) -> ShardedTrainStep:
    """(state, images, labels) -> (state, loss): make_train_step's AdamW
    step over the mesh, in place on state.params (ShardedTrainStep says
    what a captured step's key holds and how long each result is valid).
    opt_or_hparams: an AdamW (make_train_step's, its hyper-parameters
    copied) or a dict of AdamW's lr, betas, eps and weight_decay
    (defaults: create_train_state's).  capture=True needs a mesh of one
    device (a ValueError names capture=False otherwise)."""
    return ShardedTrainStep(model, opt_or_hparams, mesh, capture, graphs)


def _sum_grads(params: ShardedParams, in_place: bool = False) -> None:
    """Each shard's gradient becomes the sum over `data` of its copies;
    a replicated parameter's, the sum over `model` as well (each model
    shard's copy saw only the paths through its own slices).  in_place
    writes the sums into the gradients' own tensors (a captured step's)."""
    n_data, n_model = params.mesh.shape
    for name, spec in params.specs.items():
        leaves = [[params.shards[r][m][name] for m in range(n_model)] for r in range(n_data)]
        grads = [[t.grad if t.grad is not None else torch.zeros_like(t) for t in row]
                 for row in leaves]
        if spec is None:
            grads = [all_sum(row) for row in grads]
        cols = [all_sum([grads[r][m] for r in range(n_data)]) for m in range(n_model)]
        for r in range(n_data):
            for m in range(n_model):
                if in_place:
                    leaves[r][m].grad.copy_(cols[m][r])
                else:
                    leaves[r][m].grad = cols[m][r]


# ----------------------------------------------------------------------
# inference: rows over `model`
# ----------------------------------------------------------------------
def row_split(h: int, n_model: int, stride: int) -> List[Tuple[int, int]]:
    """The model shards' row ranges of an h-row image: each starts on a
    multiple of the net's total stride, the last may be shorter, and a
    shard with no rows is left out."""
    rows = -(-(-(-h // n_model)) // stride) * stride
    return [(a, min(a + rows, h)) for a in range(0, h, rows)]


def _rows(parts, ranges, lo: int, hi: int, height: int, dev) -> torch.Tensor:
    """Rows [lo, hi) of the row-split tensor (parts[m] holds rows
    ranges[m]) on `dev`: the halo exchange, zeros outside [0, height)."""
    like = parts[0]
    zeros = lambda k: like.new_zeros((*like.shape[:2], k, like.shape[3])).to(dev)  # noqa: E731
    pieces = [zeros(-lo)] if lo < 0 else []
    for (a, b), p in zip(ranges, parts):
        o0, o1 = max(lo, a), min(hi, b)
        if o0 < o1:
            pieces.append(p[:, :, o0 - a:o1 - a].to(dev))
    if hi > height:
        pieces.append(zeros(hi - height))
    return torch.cat(pieces, 2)


def _conv_rows(conv: Conv, weights, parts, ranges, out_ranges, height: int):
    """conv (padding "SAME" from the full height and width) of a row-split
    activation: each shard reads its rows plus the halo its window needs
    and computes its own output rows."""
    k, s, dil = conv.k, conv.stride, conv.dilation
    top, _ = _same_pads(height, k, s, dil)
    out = []
    for m, ((oa, ob), x) in enumerate(zip(out_ranges, parts)):
        lo = oa * s - top
        xin = _rows(parts, ranges, lo, (ob - 1) * s - top + (k - 1) * dil + 1, height,
                    x.device).to(conv.dtype)
        left, right = _same_pads(xin.shape[3], k, s, dil)
        xin = F.pad(xin, (left, right, 0, 0))
        w, b = weights[m]
        out.append(F.conv2d(xin, w.to(conv.dtype), None if b is None else b.to(conv.dtype),
                            s, 0, dil))
    return out


def _norm_rows(norm: GroupNorm, weights, parts):
    """GroupNorm of a row-split activation: the per-group sums of x and
    x^2 are added over the shards before flax's E[x^2] - E[x]^2."""
    n, c = parts[0].shape[:2]
    count = sum(p.shape[2] for p in parts) * parts[0].shape[3] * (c // norm.groups)
    xf = [p.float() for p in parts]
    grouped = [x.reshape(n, norm.groups, -1) for x in xf]
    s1 = all_sum([g.sum(-1) for g in grouped])
    s2 = all_sum([(g * g).sum(-1) for g in grouped])
    out = []
    for m, x in enumerate(xf):
        mu = s1[m] / count
        var = torch.clamp(s2[m] / count - mu * mu, min=0.0)
        out.append(normalize(x, mu, var, weights[m][0], weights[m][1], norm.dtype))
    return out


class ShardedInfer:
    """make_sharded_infer's inference: images f32 [N, H, W, 3] in [0, 1]
    (on any device, or a host array) -> sigmoid(model(images)) f32 [N, H,
    W, 2] on the mesh's first device, the batch over `data` (N a multiple
    of it) and the image height over `model`, with the net's current
    parameters.

    With capture=True the mesh is one device and a call one captured step
    (utils/graphs.py): the images through pinned staging (two slots) or
    copied into the step's buffer, the row shards, their halo moves and
    GroupNorm sums as one CUDA graph that reads the parameters in place
    (a move to the device they live on is none, so a replay sees every
    update); the key holds the images' shape and dtype, the staging slot
    and the storage of the net's parameters and buffers, so replaced
    parameters or a new net capture anew.  Each call returns a fresh
    tensor, valid after later calls.  On the CPU the same step runs
    eagerly; capture=False runs it eagerly on any mesh, the parameters
    copied to each device a call (no copy where they already live)."""

    def __init__(self, model: UNetSeg, mesh: np.ndarray, capture: bool = True,
                 graphs: Optional[StepGraphs] = None):
        _check(model)
        self.model, self.mesh, self.capture = model, mesh, capture
        if capture:
            self.device = _one_card(mesh, "make_sharded_infer")
            self.graphs = graphs if graphs is not None else StepGraphs(self.device)
        self._batches: dict = {}
        self._outputs: dict = {}
        self._tick = 0

    def _infer(self, images: torch.Tensor) -> torch.Tensor:
        model, mesh = self.model, self.mesh
        n_data, n_model = mesh.shape
        n, h = images.shape[:2]
        ranges0 = row_split(h, n_model, 2 ** len(model.widths))
        b = n // n_data
        outs = []
        with torch.no_grad():
            for r in range(n_data):
                devs = list(mesh[r][:len(ranges0)])
                x = images[r * b:(r + 1) * b].permute(0, 3, 1, 2)
                parts = [x[:, :, a:e].to(d).to(model.dtype) for (a, e), d in zip(ranges0, devs)]
                logits = _unet_rows(model, parts, ranges0, h, devs)
                outs.append(torch.cat([torch.sigmoid(p).to(mesh[0, 0]) for p in logits], 2))
        return torch.cat(outs, 0).permute(0, 2, 3, 1)

    def __call__(self, images) -> torch.Tensor:
        n_data = self.mesh.shape[0]
        if images.shape[0] % n_data:
            raise ValueError(f"batch {images.shape[0]} does not split over {n_data} data rows")
        if not self.capture:
            with exact_fp32():
                return self._infer(torch.as_tensor(images))
        slot = self._tick % 2
        self._tick += 1
        inputs, staged, key = batch_inputs(self._batches, self.device, slot, images=images)
        key = ("sharded_infer",) + key + module_key(self.model)

        def body():
            if staged:
                inputs.upload(slot)
            keep(self._outputs, key, self._infer(inputs.dev["images"]).contiguous())

        with exact_fp32():
            self.graphs.run(key, body)
        if staged:
            inputs.done(slot)
        return self._outputs[key][0].clone()


def make_sharded_infer(model: UNetSeg, mesh: np.ndarray, capture: bool = True,
                       graphs: Optional[StepGraphs] = None) -> ShardedInfer:
    """images f32 [N, H, W, 3] in [0, 1] -> sigmoid(model(images)) f32
    [N, H, W, 2] on the mesh's first device, the batch over `data` and the
    image height over `model` (ShardedInfer says what a captured call's
    key holds and how long each result is valid).  capture=True needs a
    mesh of one device (a ValueError names capture=False otherwise)."""
    return ShardedInfer(model, mesh, capture, graphs)


def _unet_rows(model: UNetSeg, parts, ranges0, h: int, devs):
    """UNetSeg.forward over row shards (parts[m] holds rows ranges0[m] on
    devs[m]); returns each shard's logits rows."""
    def on(mod: nn.Module):
        return [(mod.weight.to(d), None if getattr(mod, "bias", None) is None
                 else mod.bias.to(d)) for d in devs]

    def level(lv):  # the shards' rows and the height at 1 / 2^lv
        return [(a >> lv, -(-e // 2 ** lv)) for a, e in ranges0], -(-h // 2 ** lv)

    def layer(xs, lv_in, conv, norm=None):
        ranges, height = level(lv_in)
        out_ranges, _ = level(lv_in + (conv.stride == 2))
        ys = _conv_rows(conv, on(conv), xs, ranges, out_ranges, height)
        return ys if norm is None else [F.silu(y) for y in _norm_rows(norm, on(norm), ys)]

    def block(i, xs, lv):
        blk = model.blocks[i]
        return layer(xs, lv, blk.conv, blk.norm)

    n = len(model.widths)
    xs, lv, skips = parts, 0, []
    for i in range(n):
        xs = block(2 * i, xs, lv)
        lv += model.blocks[2 * i].conv.stride == 2
        xs = block(2 * i + 1, xs, lv)
        skips.append((xs, lv))
    xs = block(2 * n, xs, lv)
    lv += 1
    xs = block(2 * n + 1, xs, lv)
    for j, (skip, skip_lv) in enumerate(reversed(skips)):
        up = [_upsample2(a, s) for a, s in zip(xs, skip)]
        xs = layer(up, skip_lv, model.convs[j], model.norms[j])
        xs = block(2 * n + 2 + j, [torch.cat([a, s], dim=1) for a, s in zip(xs, skip)],
                   skip_lv)
        lv = skip_lv
    return layer(xs, lv, model.convs[-1])

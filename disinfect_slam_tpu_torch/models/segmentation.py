"""High-touch / low-touch semantic segmentation (counterpart of
disinfect_slam_tpu/models/segmentation.py; reference
segmentation/inference.{h,cc}).

The contract is the reference's:

  - input: an RGB image resized to 640x352 and divided by 255
    (inference.cc:8-9, 50);
  - output: a 2-channel probability map, channel 0 high-touch (ht) and
    channel 1 low-touch (lt), resized to 640x360 (inference.cc:46-69).

The nets are the JAX package's UNetSeg and FastSeg, module for module,
over NCHW tensors, and they load the JAX package's shipped weights
(`state_dict_from_flax`).  What flax does implicitly is written out:

  - padding "SAME" is computed per side as XLA does, so a stride-2 conv
    on an even side pads (0, 1), not torch's symmetric (1, 1);
  - GroupNorm takes its statistics in float32 with epsilon 1e-6 and casts
    the result to the working dtype (flax's force_float32_reductions);
  - the working dtype (bfloat16 by default) applies to each conv's input
    and kernel at use, the parameters stay float32, and the 1x1 head runs
    in float32 with its bias;
  - on CUDA the forward and the resize matmuls run in full float32 where
    they are float32: TF32 is off for their duration (`exact_fp32`).

No Pallas kernel exists for any of this in the JAX package (its convs,
GroupNorm and SiLU are XLA ops); here they are torch ops (cuDNN convs on
the card).
"""

from __future__ import annotations

import functools
import itertools
import os
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import exact_fp32, resolve_device

# reference contract (inference.cc:49-50, 25)
INFER_W, INFER_H = 640, 352
OUTPUT_W, OUTPUT_H = 640, 360


@functools.lru_cache(maxsize=None)
def _linear_resize_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """Dense [n_out, n_in] row-stochastic linear-resample matrix with
    half-pixel centres and triangle anti-aliasing on downscale, the JAX
    package's formula in float32 op for op.  Read-only (it is cached)."""
    f32 = np.float32
    scale = n_in / n_out
    s = max(scale, 1.0)
    src = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(scale) - f32(0.5)
    j = np.arange(n_in, dtype=f32)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(j[None, :] - src[:, None]) / f32(s))
    w = w / np.sum(w, axis=1, keepdims=True, dtype=f32)
    w.setflags(write=False)
    return w


@functools.lru_cache(maxsize=None)
def _linear_resize_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    # kept for the process (a handful of sizes): a captured online step
    # reads the cached matrices, so they are never freed under it
    return torch.from_numpy(_linear_resize_matrix_np(n_in, n_out).copy()).to(device)


def resize_chw(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[..., H, W] -> [..., out_h, out_w] float32 linear resize as two
    matmuls, the vertical one first (as the JAX package contracts)."""
    h, w = x.shape[-2:]
    a_v = _linear_resize_matrix(h, out_h, x.device)
    a_u = _linear_resize_matrix(w, out_w, x.device)
    with exact_fp32():
        return torch.matmul(torch.matmul(a_v, x.float()), a_u.t())


def resize_linear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[H, W, C] -> [out_h, out_w, C] linear resize (the JAX package's
    layout and semantics)."""
    return resize_chw(img.permute(2, 0, 1), out_h, out_w).permute(1, 2, 0)


def _same_pads(size: int, k: int, stride: int, dilation: int) -> Tuple[int, int]:
    """XLA's padding "SAME": the output is ceil(size / stride) and the
    odd pixel of the total padding goes to the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax.linen.Conv with padding "SAME": float32 kernel [O, I, k, k],
    cast with the input to `dtype` at use."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dilation: int = 1, bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.k, self.stride, self.dilation, self.dtype = k, stride, dilation, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        (t, b), (lft, r) = (
            _same_pads(n, self.k, self.stride, self.dilation) for n in x.shape[-2:]
        )
        pad = (t, lft)
        if (t, lft) != (b, r):  # asymmetric: pad explicitly, then none in the conv
            x = F.pad(x, (lft, r, t, b))
            pad = 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias, self.stride, pad,
                        self.dilation)


def group_norm(x: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """flax.linen.GroupNorm of x [N, C, H, W]: statistics in float32,
    epsilon 1e-6, float32 scale and bias [C], result in `dtype`."""
    n, c, h, w = x.shape
    xf = x.float()
    g = xf.reshape(n, groups, -1)
    # flax's fast variance E[x^2] - E[x]^2 (clipped at 0), not torch's
    # two-pass one: on flat image regions the two differ by far more
    # than a rounding, and the JAX package's weights saw flax's
    mu = g.mean(-1)
    var = torch.clamp((g * g).mean(-1) - mu * mu, min=0.0)
    return normalize(xf, mu, var, weight, bias, dtype)


def normalize(xf: torch.Tensor, mu: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """GroupNorm's affine step: float32 xf [N, C, H, W], per-group mean
    and variance [N, G] -> (xf - mu) * rsqrt(var + 1e-6) * weight + bias
    in `dtype`."""
    rep = xf.shape[1] // mu.shape[1]
    mul = torch.rsqrt(var + 1e-6).repeat_interleave(rep, 1) * weight
    mu = mu.repeat_interleave(rep, 1)
    y = (xf - mu[..., None, None]) * mul[..., None, None] + bias[:, None, None]
    return y.to(dtype)


class GroupNorm(nn.Module):
    """flax.linen.GroupNorm (group_norm) with float32 scale and bias."""

    def __init__(self, groups: int, ch: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.groups, self.dtype = groups, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.groups, self.weight, self.bias, self.dtype)


class ConvBlock(nn.Module):
    """3x3 conv (no bias) -> GroupNorm(min(32, features)) -> SiLU."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = Conv(cin, features, 3, stride=stride, dtype=dtype)
        self.norm = GroupNorm(min(32, features), features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.norm(self.conv(x)))


def _upsample2(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample (an exact repeat) cropped to like's size."""
    h, w = like.shape[-2:]
    return F.interpolate(x, scale_factor=2, mode="nearest")[..., :h, :w]


class UNetSeg(nn.Module):
    """Encoder-decoder segmentation net with skip connections.

    Submodules are held in flax's creation order: `blocks[i]` is
    ConvBlock_i, `convs[j]` is Conv_j (the decoder's up-convs, then the
    1x1 head), `norms[j]` is GroupNorm_j (the decoder's)."""

    def __init__(self, widths: Sequence[int] = (32, 64, 128, 256),
                 num_classes: int = 2, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.widths, self.dtype = tuple(widths), dtype
        blocks, cin = [], 3
        for i, w in enumerate(self.widths):
            blocks += [ConvBlock(cin, w, stride=1 if i == 0 else 2, dtype=dtype),
                       ConvBlock(w, w, dtype=dtype)]
            cin = w
        blocks += [ConvBlock(cin, cin, stride=2, dtype=dtype),
                   ConvBlock(cin, cin, dtype=dtype)]
        convs, norms = [], []
        for w in reversed(self.widths):
            convs.append(Conv(cin, w, 3, dtype=dtype))
            norms.append(GroupNorm(min(32, w), w, dtype=dtype))
            blocks.append(ConvBlock(2 * w, w, dtype=dtype))
            cin = w
        convs.append(Conv(cin, num_classes, 1, bias=True, dtype=torch.float32))
        self.blocks = nn.ModuleList(blocks)
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x f32 [N, 3, H, W] in [0, 1] -> logits f32 [N, 2, H, W]."""
        x = x.to(self.dtype)
        n = len(self.widths)
        skips = []
        for i in range(n):
            x = self.blocks[2 * i + 1](self.blocks[2 * i](x))
            skips.append(x)
        x = self.blocks[2 * n + 1](self.blocks[2 * n](x))  # bottleneck
        for j, skip in enumerate(reversed(skips)):
            x = F.silu(self.norms[j](self.convs[j](_upsample2(x, skip))))
            x = self.blocks[2 * n + 2 + j](torch.cat([x, skip], dim=1))
        return self.convs[-1](x)


class FastSeg(nn.Module):
    """Latency-first variant: a residual dilated-conv trunk (dilations
    cycling 1, 2, 4) at 1/4 resolution plus one half-resolution skip;
    the logits are resized to the input size.

    `blocks[0..2]` are ConvBlock_0..2, `convs[0..depth-1]` the trunk's
    Conv_i with `norms[i]` its GroupNorm_i (32 groups), `convs[depth]`
    the 1x1 head."""

    def __init__(self, width: int = 128, depth: int = 6, num_classes: int = 2,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        half = width // 2
        self.blocks = nn.ModuleList([
            ConvBlock(3, half, stride=2, dtype=dtype),
            ConvBlock(half, width, stride=2, dtype=dtype),
            ConvBlock(width + half, half, dtype=dtype),
        ])
        self.convs = nn.ModuleList(
            [Conv(width, width, 3, dilation=2 ** (i % 3), dtype=dtype)
             for i in range(depth)]
            + [Conv(half, num_classes, 1, bias=True, dtype=torch.float32)]
        )
        self.norms = nn.ModuleList([GroupNorm(32, width, dtype=dtype)
                                    for _ in range(depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x f32 [N, 3, H, W] in [0, 1] -> logits f32 [N, 2, H, W]."""
        h, w = x.shape[-2:]
        s2 = self.blocks[0](x.to(self.dtype))
        x = self.blocks[1](s2)
        for conv, norm in zip(self.convs[:-1], self.norms):
            x = x + F.silu(norm(conv(x)))
        x = self.blocks[2](torch.cat([_upsample2(x, s2), s2], dim=1))
        return resize_chw(self.convs[-1](x), h, w)


def _init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from `generator`: conv kernels normal with std
    1/sqrt(fan_in) (flax's lecun_normal scale), norms at scale 1, biases
    0."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Conv):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, fan_in ** -0.5, generator=generator)


def create_model(widths: Sequence[int] = (32, 64, 128, 256),
                 dtype: torch.dtype = torch.bfloat16, arch: str = "unet",
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Model family: 'unet' (quality) or 'fast' (latency), randomly
    initialised from `generator` (seed 0 when None)."""
    if arch == "fast":
        model = FastSeg(width=max(widths), dtype=dtype)
    elif arch == "unet":
        model = UNetSeg(widths=widths, dtype=dtype)
    else:
        raise ValueError(f"arch must be 'unet' or 'fast', got {arch!r}")
    _init_params(model, generator or torch.Generator().manual_seed(0))
    return model.eval()


def init_params(model: nn.Module, generator: Optional[torch.Generator] = None,
                h: int = INFER_H, w: int = INFER_W) -> Dict[str, np.ndarray]:
    """Initialise `model`'s parameters in place from `generator` (seed 0
    when None), as create_model does, check that the net takes an
    [1, 3, h, w] input, and return the parameters under their flat flax
    names (the JAX package's init_params(model, rng, h, w) tree,
    flattened)."""
    _init_params(model, generator or torch.Generator().manual_seed(0))
    dev = next(model.parameters()).device
    with torch.no_grad():
        model(torch.zeros((1, 3, h, w), device=dev))
    return flax_from_state_dict(model.state_dict())


# ----------------------------------------------------------------------
# weights: the JAX package's flat npz checkpoints
# ----------------------------------------------------------------------
def default_weights_path(arch: str = "unet") -> str:
    """The JAX package's shipped checkpoint, read in place."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "disinfect_slam_tpu", "models", "weights",
                        f"seg_{arch}_f16.npz")


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    """Flat flax parameter names ('params/ConvBlock_0/Conv_0/kernel', ...)
    -> float32 arrays (the checkpoints are stored in float16)."""
    with np.load(path) as z:
        return {k: z[k].astype(np.float32) for k in z.files}


def load_default_params(arch: str = "unet") -> Optional[Dict[str, np.ndarray]]:
    """The shipped checkpoint's flat parameters, or None if absent."""
    path = default_weights_path(arch)
    return load_params_npz(path) if os.path.exists(path) else None


_FLAX_NAME = re.compile(
    r"params/(ConvBlock|Conv|GroupNorm)_(\d+)/(?:(Conv|GroupNorm)_0/)?(kernel|scale|bias)")
_PARAM = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def state_dict_from_flax(flat: Dict[str, np.ndarray], model: nn.Module) -> Dict[str, torch.Tensor]:
    """Map flat flax names to `model`'s state_dict: ConvBlock_i ->
    blocks.i.{conv,norm}, Conv_j -> convs.j, GroupNorm_j -> norms.j; conv
    kernels go from HWIO to OIHW.  Raises KeyError naming a key that is
    missing or not the model's, ValueError naming a misshapen one."""
    want = model.state_dict()
    out = {}
    for name, arr in flat.items():
        m = _FLAX_NAME.fullmatch(name)
        if m is None:
            raise KeyError(f"{name}: not a parameter of {type(model).__name__}")
        scope, idx, inner, leaf = m.groups()
        if scope == "ConvBlock":
            if inner is None:
                raise KeyError(f"{name}: not a parameter of {type(model).__name__}")
            key = f"blocks.{idx}.{'conv' if inner == 'Conv' else 'norm'}.{_PARAM[leaf]}"
        elif inner is not None:
            raise KeyError(f"{name}: not a parameter of {type(model).__name__}")
        else:
            key = f"{'convs' if scope == 'Conv' else 'norms'}.{idx}.{_PARAM[leaf]}"
        if key not in want:
            raise KeyError(f"{name}: not a parameter of {type(model).__name__} ({key})")
        t = torch.from_numpy(np.array(arr, np.float32))
        if leaf == "kernel":
            t = t.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
        if tuple(t.shape) != tuple(want[key].shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} does not fit {key} "
                             f"{tuple(want[key].shape)}")
        out[key] = t
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"missing parameters for {', '.join(missing)}")
    return out


_FLAX_SCOPE = {"conv": "Conv_0", "norm": "GroupNorm_0"}
_FLAX_LEAF = {("conv", "weight"): "kernel", ("conv", "bias"): "bias",
              ("norm", "weight"): "scale", ("norm", "bias"): "bias"}


def flax_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of state_dict_from_flax: a model's state_dict ->
    flat flax names -> float32 arrays, conv kernels from OIHW to HWIO."""
    out = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        if parts[0] == "blocks" and len(parts) == 4 and parts[2] in _FLAX_SCOPE:
            kind = parts[2]
            name = f"params/ConvBlock_{parts[1]}/{_FLAX_SCOPE[kind]}/"
        elif parts[0] in ("convs", "norms") and len(parts) == 3:
            kind = parts[0][:-1]
            name = f"params/{'Conv' if kind == 'conv' else 'GroupNorm'}_{parts[1]}/"
        else:
            raise KeyError(f"{key}: not a parameter of the segmentation nets")
        leaf = _FLAX_LEAF.get((kind, parts[-1]))
        if leaf is None:
            raise KeyError(f"{key}: not a parameter of the segmentation nets")
        a = t.detach().float().cpu()
        if leaf == "kernel":
            a = a.permute(2, 3, 1, 0)  # OIHW -> HWIO
        out[name + leaf] = a.contiguous().numpy()
    return out


def load_model(arch: str = "unet", path: Optional[str] = None, device="cuda",
               params: Optional[Dict[str, np.ndarray]] = None) -> nn.Module:
    """The shipped net (or the npz checkpoint at `path`, or the flat flax
    `params` already read) in bfloat16 on `device` (CUDA unless the
    caller asks for another)."""
    device = resolve_device(device)
    model = create_model(arch=arch)
    if params is None:
        params = load_params_npz(path or default_weights_path(arch))
    model.load_state_dict(state_dict_from_flax(params, model))
    return model.to(device)


# ----------------------------------------------------------------------
# inference
# ----------------------------------------------------------------------
def segment(model: nn.Module, rgb: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """rgb [H, W, 3] (u8 or f32 in [0, 255]) on the model's device ->
    probabilities f32 [2, out_h, out_w] (ht, lt): resize to 640x352, /255,
    forward, sigmoid, resize."""
    with torch.no_grad(), exact_fp32():
        x = resize_chw(rgb.float().permute(2, 0, 1), INFER_H, INFER_W)
        # a device tensor divisor: torch on CUDA divides by a Python scalar
        # through its reciprocal
        x = x / torch.full((), 255.0, device=x.device)
        probs = torch.sigmoid(model(x[None])[0])
        return resize_chw(probs, out_h, out_w)


class InferenceEngine:
    """API parity with segmentation::inference_engine (inference.h:11-22):
    infer_one(rgb, ret_uint8) -> [ht_map, lt_map], each 640x360 like
    float_tensor_to_float_mat (inference.cc:25).  `model` carries its
    weights and runs on the device it is on.

    The counterpart of the JAX engine's jitted `_forward`: on a CUDA device
    each frame is one captured step (utils/graphs.py) keyed by the frame's
    (H, W, dtype), the staging slot and the net's storage.  The u8 or f32
    frame goes through pinned staging (two slots, used in turn), `segment`
    runs with TF32 off while it is captured and replayed, and the [2, H,
    W] maps come back in one copy into a pinned host buffer.
    capture=False runs `segment` eagerly."""

    def __init__(self, model: nn.Module, out_size: Tuple[int, int] = (OUTPUT_H, OUTPUT_W),
                 capture: bool = True, graphs=None):
        from ..utils.graphs import StepGraphs

        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.out_h, self.out_w = out_size
        self.capture = capture
        self.graphs = graphs if graphs is not None else StepGraphs(self.device)
        self._inputs = {}
        self._outputs = {}
        self._tick = 0
        self._host_out = None

    def _run(self, rgb: np.ndarray) -> torch.Tensor:
        """The frame (u8 or f32, contiguous) through the captured step ->
        the maps [2, out_h, out_w] in its static output on the device
        (valid until this engine's next call)."""
        from ..utils.graphs import StaticInputs, keep

        h, w = rgb.shape[:2]
        dtype = torch.from_numpy(rgb[:0]).dtype
        key = (tuple(rgb.shape), dtype)
        if key not in self._inputs:
            self._inputs[key] = StaticInputs({"rgb": (tuple(rgb.shape), dtype)}, self.device)
        inputs = self._inputs[key]
        slot = self._tick % 2
        self._tick += 1
        inputs.fill(slot, rgb=rgb)

        def body():
            inputs.upload(slot)
            keep(self._outputs, "probs", segment(self.model, inputs.dev["rgb"], self.out_h,
                                                 self.out_w))

        net = tuple(t.data_ptr() for t in itertools.chain(self.model.parameters(),
                                                           self.model.buffers()))
        with exact_fp32():
            self.graphs.run(("seg", h, w, dtype, slot, self.out_h, self.out_w, net), body)
        inputs.done(slot)
        return self._outputs["probs"][0]

    def infer_one(self, rgb_img: np.ndarray, ret_uint8: bool = False):
        from ..utils.graphs import host_image

        rgb = host_image(rgb_img)
        if self.capture:
            probs = self._run(rgb)
            if self._host_out is None:
                self._host_out = torch.empty(tuple(probs.shape), dtype=probs.dtype,
                                             pin_memory=self.device.type == "cuda")
            self._host_out.copy_(probs, non_blocking=True)  # the one copy to the host
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            probs = self._host_out.numpy().copy()
        else:
            # u8 uploads 4x fewer bytes and widens on the device
            img = torch.from_numpy(rgb).to(self.device)
            probs = segment(self.model, img, self.out_h, self.out_w).cpu().numpy()
        ht, lt = probs[0], probs[1]
        if ret_uint8:
            ht = np.clip(ht * 255, 0, 255).astype(np.uint8)
            lt = np.clip(lt * 255, 0, 255).astype(np.uint8)
        return [ht, lt]

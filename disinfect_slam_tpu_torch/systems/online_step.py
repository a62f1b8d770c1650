"""The online step: segmentation feeding fusion, one call per frame
(counterpart of disinfect_slam_tpu/systems/online_step.py; reference
examples/tsdf/online.cc:23-70).

    rgb, depth, pose --H2D--> [ seg forward -> ht/lt -> integrate ] -> volume'

The semantic maps never leave the device.  Sensor formats convert on the
device: u8 rgb widens to float32 and u16 depth counts divide by
depth_factor (l515.cc:9-13 Z16 depth + RGB8 colour), so a frame uploads
3.3x fewer bytes than in float32.  The seg contract is InferenceEngine's
(models/segmentation.py), except that the probability map is resized
straight to the frame size instead of through the reference's 640x360.

The JAX package's `split_dispatch` option is left out: it splits seg and
fusion into two XLA programs so that the compiler's layout assignment of
one does not degrade the other.  Eager torch compiles no such program;
here seg and fusion are always separate launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import TSDFConfig
from ..core.geometry import SE3, CameraIntrinsics, CameraParams
from ..core.state import TSDFVolume
from ..models.segmentation import segment
from ..ops.integrate import FrameInput, integrate
from ..utils.device import resolve_device


class FusedOnlineStep:
    """Owns a volume and advances it by one rgb + depth + pose frame.

    seg_model None = no-segmentation mode (ht = lt = 1, the
    online_no_seg.cc contract, tsdf_module.cc:32-33); otherwise the
    port's net with its weights loaded, moved to `device`."""

    def __init__(
        self,
        cfg: TSDFConfig,
        intrinsics: Tuple[float, float, float, float],
        img_h: int,
        img_w: int,
        max_depth: float,
        seg_model: Optional[nn.Module] = None,
        depth_factor: float = 1000.0,
        device="cuda",
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.img_h, self.img_w = img_h, img_w
        self.max_depth = float(max_depth)
        self.cam = CameraParams.create(CameraIntrinsics.create(*intrinsics), img_h, img_w)
        self.volume = TSDFVolume.create(cfg, self.device)
        self.seg_model = None if seg_model is None else seg_model.to(self.device).eval()
        # a device tensor divisor: torch on CUDA divides by a Python scalar
        # through its reciprocal, not as the JAX package's f32 division
        self._depth_factor = torch.full((), float(depth_factor), dtype=torch.float32,
                                        device=self.device)
        self._tick = 0

    def step_device(self, rgb: torch.Tensor, depth: torch.Tensor, pose_mat) -> None:
        """Advance one frame from tensors on the device: rgb u8 or f32
        [H, W, 3] in [0, 255]; depth u16 sensor counts or f32 metres
        [H, W]; pose_mat the 4x4 cam_T_world (host).  Honours
        cfg.alloc_every (fusion every frame, allocation on every N-th)."""
        allocate = self._tick % max(self.cfg.alloc_every, 1) == 0
        self._tick += 1
        rgb = rgb.float()
        if depth.dtype == torch.uint16:
            depth = depth.float() / self._depth_factor
        if self.seg_model is not None:
            ht, lt = segment(self.seg_model, rgb, self.img_h, self.img_w)
        else:
            ht = lt = torch.ones_like(depth)
        frame = FrameInput(rgb=rgb, depth=depth, ht=ht, lt=lt)
        self.volume = integrate(self.volume, frame, self.cam, SE3.from_matrix(pose_mat),
                                self.max_depth, allocate=allocate)

    def step(self, rgb: np.ndarray, depth: np.ndarray, pose: np.ndarray) -> None:
        """Advance one frame from host arrays (the upload included): rgb u8
        and depth u16 upload as they are, anything else as float32."""
        rgb, depth = np.asarray(rgb), np.asarray(depth)
        if rgb.dtype != np.uint8:
            rgb = rgb.astype(np.float32)
        if depth.dtype != np.uint16:
            depth = depth.astype(np.float32)
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        self.step_device(up(rgb), up(depth), np.asarray(pose, np.float32))

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def num_active_blocks(self) -> int:
        return int(self.volume.num_active_blocks)

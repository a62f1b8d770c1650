"""Train the ht/lt segmentation net on procedural scenes with the PyTorch
port (counterpart of apps/train_seg.py).

The reference's model weights were never published (its inference engine
loads an external TorchScript .pt, segmentation/inference.cc:39-44); the
JAX package's shipped checkpoints came from its train_seg app, and this
app retrains them without JAX.  The net is fully convolutional, so
training runs at a reduced resolution and the weights apply unchanged at
the 640x352 inference contract.  Same flags, schedule (linear warmup over
min(50, steps // 5) steps, then cosine decay), held-out set (8 scenes from
default_rng(10000 + seed)) and printed lines as the JAX app; --device
takes the place of --cpu.

  python -m disinfect_slam_tpu_torch.apps.train_seg --steps 400 --out seg_unet_f16.npz

--out defaults to seg_{arch}_f16.npz in the current directory, never to
the JAX package's shipped weights.  The file is the shipped flat-flax
float16 npz: load it with models/segmentation.py:load_model(arch, path)
(or the JAX package's load_params_npz), or pass it to apps.online
--seg-weights.  It runs on the CUDA device unless asked for another
(--device cpu); there the train and eval steps replay as CUDA graphs, as
the JAX app runs them jitted (models/train.py), each batch going to the
card through pinned staging.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..models.segmentation import create_model
from ..models.synth_data import make_batch
from ..models.train import (
    create_train_state, make_eval_step, make_train_step, save_params_npz,
    warmup_cosine_decay_schedule,
)
from ..utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--arch", default="unet", choices=["unet", "fast"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="checkpoint path (default: seg_{arch}_f16.npz in the working directory)")
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device for the net; without CUDA the run stops "
                         "unless this is cpu")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Train; returns the state, the output path, the final held-out
    IoU [ht, lt] and the training wall seconds."""
    device = resolve_device(args.device)
    model = create_model(arch=args.arch, generator=torch.Generator().manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train_seg] {args.arch}: {n_params/1e6:.2f} M params", flush=True)

    sched = warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=min(50, args.steps // 5), decay_steps=args.steps)
    state = create_train_state(model, lr=sched, device=device)
    step_fn = make_train_step(state.model, state.opt)
    eval_fn = make_eval_step(state.model)

    # held-out eval set (fixed seed disjoint from the training stream)
    eval_rng = np.random.default_rng(10_000 + args.seed)
    ev_imgs, ev_labs = (torch.from_numpy(a).to(device)
                        for a in make_batch(eval_rng, 8, args.height, args.width))

    t0 = time.time()
    for i in range(args.steps):
        state, loss = step_fn(state, *make_batch(rng, args.batch, args.height, args.width))
        if (i + 1) % args.eval_every == 0 or i == 0:
            m = eval_fn(ev_imgs, ev_labs)
            iou = m["iou"].cpu().numpy()
            print(
                f"[train_seg] step {i+1}/{args.steps} loss={float(loss):.4f} "
                f"eval_loss={float(m['loss']):.4f} "
                f"iou_ht={iou[0]:.3f} iou_lt={iou[1]:.3f} "
                f"({time.time()-t0:.0f}s)",
                flush=True,
            )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.time() - t0

    out = args.out or f"seg_{args.arch}_f16.npz"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    save_params_npz(out, state)
    iou = eval_fn(ev_imgs, ev_labs)["iou"].cpu().numpy()
    print(
        f"[train_seg] saved {out} ({os.path.getsize(out)/1e6:.1f} MB) "
        f"final iou_ht={iou[0]:.3f} iou_lt={iou[1]:.3f}",
        flush=True,
    )
    return {"state": state, "out": out, "iou": iou, "train_s": train_s}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()

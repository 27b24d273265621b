#!/usr/bin/env python3
"""Why chip_smoke.py's train_rec trains at lr 1e-3: variants of its
training run side by side on one NVIDIA GPU.

    python3 chip_rec_probe.py [variant ...]

The records, the iterator and the batches are phase train_rec's (2048
raw-pixel 256 x 256 images from numpy seed 0, labels i % 10, ImageRecordIter
at batch 128 over two epochs, normalised on the card as bench.py does); the
32 batches are placed on the card once and every variant trains
ResNet-50 v1 through parallel.ShardedTrainStep (SGD, momentum 0.9) on the
same sequence. Variants (default: all):

- xavier_lr1e-2: NHWC, fuse=True, bf16, Xavier(gaussian, in, 2) at
  phase train_sharded's lr 0.01;
- xavier_lr1e-2_f32_nchw: the same in float32, NCHW, fuse=False: no
  kernel of the repository runs (cuDNN and plain torch), 16 steps;
- xavier_lr1e-3 (train_rec's REC_SGD), xavier_lr1e-4: lower learning
  rates;
- he_closing_gamma_lr1e-2: lr 0.01 with the smoke run's usual weights
  (convert.random_numpy_params: He-scaled convolutions, every residual
  body's closing BatchNorm gamma in [0.1, 0.3)).

Each variant prints one JSON line: its losses, the mean loss of each
epoch, and at its initial weights the squared norm of the batch-mean
pooled feature (the input of the last Dense layer) and the mean squared
norm per image, and lr times the former. With the features of nearly
every image alike (noise pools to its mean), the loss's curvature along
the last layer's update is |mean feature|^2 times the top eigenvalue of
softmax cross-entropy's Hessian in the logits (at most 1/4; about 0.1
once the probability sits on the 10 labels), and heavy-ball SGD with
momentum 0.9 is stable only while lr times that curvature stays below
2 (1 + 0.9).
The last line is {"ok": true, ...} when every variant ran.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np

import chip_smoke as cs

VARIANTS = {
    # name: (dtype, layout, fuse, init, lr, steps)
    "xavier_lr1e-2": ("bfloat16", "NHWC", True, "xavier", 0.01, 32),
    "xavier_lr1e-2_f32_nchw": ("float32", "NCHW", False, "xavier", 0.01, 16),
    "xavier_lr1e-3": ("bfloat16", "NHWC", True, "xavier", 0.001, 32),
    "xavier_lr1e-4": ("bfloat16", "NHWC", True, "xavier", 0.0001, 32),
    "he_closing_gamma_lr1e-2": ("bfloat16", "NHWC", True, "numpy", 0.01,
                                32),
}


def _batches(torch, mx, folder):
    rec, idx = cs._write_rec(mx, folder)
    it = cs._rec_iter(mx, rec, idx)
    out = []
    for epoch in range(cs.REC_EPOCHS):
        if epoch:
            it.reset()
        for b in it:
            out.append((b.data[0]._data.cuda(), b.label[0]._data.cuda()))
    return out


def _net(torch, mx, dtype, layout, fuse, init):
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    gpu = mx.gpu(0)
    mx.random.seed(0)
    net = resnet50_v1(layout=layout, fuse=fuse)
    if init == "xavier":
        net.initialize(mx.init.Xavier(**cs.REC_XAVIER), ctx=gpu)
        net(torch.zeros((1,) + cs.REC_SHAPE, device=gpu.device))
    else:
        net.initialize(ctx=gpu)
        net(torch.zeros((1,) + cs.REC_SHAPE, device=gpu.device))
        mx.convert.load_numpy_params(net, mx.convert.random_numpy_params(
            mx.convert.param_shapes(net), seed=0))
    net.cast(dtype)
    return net


def _features(torch, net, x, layout):
    """(|batch-mean pooled feature|^2, mean per-image |feature|^2)."""
    with torch.no_grad():
        xt = x.permute(0, 2, 3, 1) if layout == "NHWC" else x
        f = net.features(xt).reshape(x.shape[0], -1).double()
    return float((f.mean(0) ** 2).sum()), float((f ** 2).sum(1).mean())


def run(torch, mx, name, batches):
    dtype, layout, fuse, init, lr, steps = VARIANTS[name]
    dev = mx.gpu(0).device
    dt = getattr(torch, dtype)
    mean = torch.tensor(cs.REC_MEAN, dtype=dt, device=dev).view(1, 3, 1, 1)
    scale = torch.tensor(cs.REC_SCALE, dtype=dt, device=dev)
    net = _net(torch, mx, dtype, layout, fuse, init)
    x0 = (batches[0][0].to(dt) - mean) * scale
    feat_mean_sq, feat_sq = _features(torch, net, x0, layout)
    step = cs._sharded_step(mx, torch, net, ("sgd", {"learning_rate": lr,
                                                    "momentum": 0.9}), dev)
    t0 = time.perf_counter()
    losses = [step.step((x.to(dt) - mean) * scale, y)
              for x, y in batches[:steps]]
    losses = [float(v) for v in losses]
    wall = time.perf_counter() - t0
    half = cs.REC_STEPS
    res = {"variant": name, "dtype": dtype, "layout": layout, "fuse": fuse,
           "init": init, "lr": lr, "momentum": 0.9, "steps": steps,
           "losses": losses,
           "loss_mean_epoch": [float(np.mean(losses[:half]))] + (
               [float(np.mean(losses[half:]))] if steps > half else []),
           "pooled_feature_mean_sq_norm": feat_mean_sq,
           "pooled_feature_sq_norm_per_image": feat_sq,
           "lr_times_feature_mean_sq_norm": lr * feat_mean_sq,
           "heavy_ball_limit": 2 * (1 + 0.9), "wall_s": wall}
    print(json.dumps(res), flush=True)
    del net, step
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args(argv)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error("unknown variants %s" % sorted(unknown))
    import torch
    if not torch.cuda.is_available():
        print("chip_rec_probe: no CUDA device", file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx
    line = cs.smi()
    print(json.dumps({"card": line, "torch": torch.__version__}), flush=True)
    folder = tempfile.mkdtemp(prefix="chip_rec_probe_")
    try:
        batches = _batches(torch, mx, folder)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    for name in args.variants:
        run(torch, mx, name, batches)
    print(json.dumps({"ok": True, "card": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

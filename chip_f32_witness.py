"""The f32 witnesses of the port's card-vs-CPU training checks.

``--net narrow`` runs the narrow NHWC ResNet of ``tests/test_torch_cuda.py``
(bottleneck [1, 1, 1, 1], widths 16-256, 10 classes, batch 4 of 16x16
images) for two SGD steps (lr 0.01, momentum 0.9) from the same numpy
weights, over several input draws; ``--net resnet50`` runs one step of
ResNet-50 v1 NHWC at batch 4 on ``chip_smoke.py``'s f32 check's inputs
(weights from numpy seed 0, the first 4 images of the batch from seed 1).
Each runs on five routes:

  card          the port on the card, every kernel launched (the test);
  card_plain    the card with every kernel's wrapper running its plain
                PyTorch version instead (so it runs none of the kernels);
  card_nocudnn  the card with cuDNN off (PyTorch's own convolutions);
  cpu32         the port on the CPU in float32 (the test's reference);
  cpu64         the port on the CPU in float64 (the true value, to f32;
                but the BatchNorm op keeps its batch statistics in
                float32, so only the fused links' folds are float64
                throughout).

It prints one JSON line per draw and net form (``fuse`` 0: the eager
record/backward/Trainer.step; 1: the fused net through gluon.train_step
with MXTPU_FUSED_APPLY=1) with the largest relative gap between routes
of the final loss, of every gradient and of every parameter and running
statistic, and whether the card passes the narrow test's bounds (loss
within 1e-5 relative, parameters within 1e-5 of their largest
magnitude); with both forms, one more line compares the fused net with
the unfused one route by route. If the card's distance from cpu64 is of
the size of cpu32's, the card's gap to the CPU is f32 rounding; if card
and card_plain differ, the kernels do. TF32 is off throughout.

    python3 chip_f32_witness.py [--net narrow|resnet50] [--fuse 0,1]
                                [--draws 8]

The first draw, ``torch_default``, is what ``torch.rand`` and
``torch.randint`` give in a fresh process (the test's inputs before they
came from a numpy seed); ``np<k>`` come from ``numpy.random.RandomState(k)``.
It needs one CUDA device and imports nothing of JAX.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

ROUTES = ("card", "card_plain", "card_nocudnn", "cpu32", "cpu64")
PAIRS = (("card", "cpu32"), ("card", "cpu64"), ("cpu32", "cpu64"),
         ("card", "card_plain"), ("card", "card_nocudnn"))
BOUND = {"loss": 1e-5, "param": 1e-5}


def draws(n):
    g = torch.Generator()      # seeded as a fresh process's default one
    yield "torch_default", torch.rand(4, 3, 16, 16, generator=g), \
        torch.randint(0, 10, (4,), generator=g).float()
    for k in range(n):
        rs = np.random.RandomState(k)
        yield "np%d" % k, \
            torch.from_numpy(rs.rand(4, 3, 16, 16).astype("float32")), \
            torch.from_numpy(rs.randint(0, 10, (4,)).astype("float32"))


def smoke_draw():
    rs = np.random.RandomState(1)
    x = rs.rand(128, 3, 224, 224).astype("float32")[:4]
    y = rs.randint(0, 1000, (128,)).astype("float32")[:4]
    yield "smoke", torch.from_numpy(x.copy()), torch.from_numpy(y.copy())


def build(mx, net_name, fuse):
    """The net, not initialized."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
    if net_name == "resnet50":
        return tres.resnet50_v1(layout="NHWC", fuse=bool(fuse))
    return tres.ResNetV1(tres.BottleneckV1, [1, 1, 1, 1],
                         [16, 32, 64, 128, 256], classes=10, thumbnail=True,
                         layout="NHWC", fuse=bool(fuse))


class plain_kernels:
    """Within the block, every kernel wrapper of the port runs its plain
    PyTorch version on the card's tensors."""

    def __enter__(self):
        from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
        from mxnet_tpu_torch.kernels import conv_fused as CF
        self.saved = []
        swaps = [(BNF, "stats", BNF.stats_reference),
                 (BNF, "apply", BNF.apply_reference),
                 (BNF, "bwd_reduce", BNF.bwd_reduce_reference),
                 (BNF, "bwd_dx", BNF.bwd_dx_reference),
                 (CF, "_launch", CF.fused_conv_reference)]
        if hasattr(CF, "fused_conv_backward_reference"):
            swaps.append((CF, "_launch_backward",
                          CF.fused_conv_backward_reference))
        try:
            from mxnet_tpu_torch.kernels import optimizer_apply as OA
            swaps.append((OA, "_launch", _apply_plain_on_card))
        except ImportError:
            pass
        for mod, name, fn in swaps:
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _apply_plain_on_card(opt, bucket, ws, gs, states, lrs, wds, rescale):
    """The per-parameter step_fn chain over one bucket, in place."""
    with torch.no_grad():
        for i in bucket:
            nw, ns = opt.step_fn(ws[i], gs[i], states[i], lrs[i], wds[i],
                                 rescale)
            ws[i].copy_(nw)
            if ns is not None:
                states[i].copy_(ns)


def run(mx, net_name, arrays, x, y, fuse, route):
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    ctx = mx.cpu() if route.startswith("cpu") else mx.gpu(0)
    dtype = "float64" if route == "cpu64" else "float32"
    net = build(mx, net_name, fuse)
    net.initialize(ctx=ctx)
    net(x[:1].to(ctx.device))
    mx.convert.load_numpy_params(net, arrays)
    net.cast(dtype)
    x = x.to(ctx.device, getattr(torch, dtype))
    y = y.to(ctx.device, getattr(torch, dtype))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.01, "momentum": 0.9})
    loss_fn = SoftmaxCrossEntropyLoss()
    if fuse:
        net.hybridize()
        step = mx.gluon.train_step(net, loss_fn, trainer)
    for _ in range(1 if net_name == "resnet50" else 2):
        if fuse:
            loss = step(x, y)
            assert step.last_mode == "fused", step.last_mode
        else:
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(x.shape[0])
    params = net._collect_params_with_prefix()
    out = {"loss": loss.detach().cpu().double(),
           "grad": {k: p.grad().detach().cpu().double()
                    for k, p in params.items() if p.grad_req != "null"},
           "param": {k: p.data().detach().cpu().double()
                     for k, p in params.items()}}
    return out


def routed(mx, net_name, arrays, x, y, fuse, route):
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = route != "card_nocudnn"
    try:
        if route == "card_plain":
            with plain_kernels():
                return run(mx, net_name, arrays, x, y, fuse, route)
        return run(mx, net_name, arrays, x, y, fuse, route)
    finally:
        torch.backends.cudnn.enabled = prev


def max_rel(a, b, what):
    """Largest |a - b| / max|b| over the tensors of ``what`` (for the
    loss, largest |a - b| / |b| per sample), and where."""
    if what == "loss":
        rel = ((a["loss"] - b["loss"]).abs() / b["loss"].abs()).max().item()
        return [rel, "loss"]
    pairs = [(k, a[what][k], b[what][k]) for k in b[what]]
    worst = [0.0, None]
    for key, u, v in pairs:
        rel = (u - v).abs().max().item() / max(v.abs().max().item(), 1e-300)
        if rel > worst[0]:
            worst = [rel, key]
    return worst


def gaps_of(runs, pairs):
    return {"%s_vs_%s" % (a, b): {w: max_rel(runs[a], runs[b], w)
                                  for w in ("loss", "grad", "param")}
            for a, b in pairs}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--net", default="narrow", choices=("narrow", "resnet50"))
    ap.add_argument("--fuse", default="0,1")
    ap.add_argument("--draws", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["MXTPU_FUSED_APPLY"] = "1"
    forms = [int(f) for f in args.fuse.split(",")]
    arrays = None
    failed = 0
    for name, x, y in (smoke_draw() if args.net == "resnet50"
                       else draws(args.draws)):
        if arrays is None:
            probe = build(mx, args.net, forms[-1])
            probe.initialize(ctx=mx.cpu())
            probe(x[:1])
            arrays = mx.convert.random_numpy_params(
                mx.convert.param_shapes(probe), seed=0)
        runs = {}
        for fuse in forms:
            with mx.precision.matmul_precision("float32"):
                for r in ROUTES:
                    runs[fuse, r] = routed(mx, args.net, arrays, x, y, fuse,
                                           r)
            gaps = gaps_of({r: runs[fuse, r] for r in ROUTES}, PAIRS)
            card = gaps["card_vs_cpu32"]
            passes = all(card[w][0] <= BOUND[w] for w in BOUND)
            failed += not passes
            print(json.dumps({"net": args.net, "fuse": fuse, "draw": name,
                              "test_bounds_pass": passes, "gaps": gaps}),
                  flush=True)
        if len(forms) == 2:
            cross = gaps_of({"%s_fuse%d" % (r, f): runs[f, r]
                             for f in forms for r in ROUTES},
                            [("%s_fuse1" % r, "%s_fuse0" % r)
                             for r in ROUTES])
            print(json.dumps({"net": args.net, "draw": name,
                              "fused_vs_unfused": cross}), flush=True)
        del runs
    print(json.dumps({"draws_failing_test_bounds": failed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase (needs one GPU)
    python3 chip_smoke.py --phases env,kernel
    python3 chip_smoke.py --phases env,kernel,train

Phases, each printing JSON lines:

1. env     -- card name and power limit, torch/CUDA versions, and the nvcc
              build of every kernel source in mxnet_tpu_torch/csrc/ (one
              nvcc per source, all started together).
2. kernel  -- each kernel against its plain PyTorch version on the card:
              conv_fused at the shapes ResNet-50 serving gives it (batch
              32) and at edge shapes; the four training-BatchNorm kernels
              (stats, apply, bwd_reduce, bwd_dx) at the nine (R, C) shapes
              of ResNet-50 training at batch 128 and at edge shapes (a
              channel of zeros, a variance that clamps to 0, an inf); bf16
              and f32, relu on and off. BatchNorm forward outputs must be
              equal bit for bit, backward within 2e-4 of max |reference|.
3. serve   -- the serving path: resnet50_v1(layout="NHWC", fuse=True) in
              bf16 answers 4 requests of 32 images (top-5 classes each).
              Launch counters are zeroed just before and read just after;
              every fused link must have gone through its kernel. Logits
              are checked against the same weights run with fuse=False (no
              kernel), then once more in f32 with TF32 off, and against the
              port on the CPU for two images.
4. train   -- the training path: resnet50_v1(layout="NHWC", fuse=False) in
              bf16, batch 128, SoftmaxCrossEntropyLoss, autograd.record(),
              loss.backward(), gluon.Trainer SGD (lr 0.01, momentum 0.9),
              5 steps on one batch. Counters are zeroed just before: each
              BatchNorm kernel must launch 53 times per step (and the
              finalize launch twice per BatchNorm), conv_fused never; the
              loss must be finite and fall. Then one f32 step at batch 4,
              TF32 off, against the port on the CPU.
5. time    -- CUDA-event times per kernel and shape (kernel, plain version,
              PyTorch library yardstick) beside the card's bound;
              whole-forward images/sec at batch 32 and 256 and the
              training step's images/sec at batch 128, in bf16, with the
              device's busy time and idle share from the profiler.

The run ends with the nvidia-smi name/power line, then the
{"kernels": [...]} line (per kernel: launches on its path, max abs error at
the ResNet-50 shapes in bf16 and its tolerance, and the times, bound,
plain and library times of one forward (conv_fused) or one training step
(the BatchNorm kernels)), then {"ok": true, "device": {...}} as the last
line. Any failure exits non-zero before them.
Weights and data are drawn from fixed seeds; nothing is downloaded.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

PHASES = ("env", "kernel", "serve", "train", "time")

# ResNet-50's fused 3x3 links at batch 32: (N, H, W, Ci, Co) and how many
# of the 16 launches per forward run at that shape.
RN50_SHAPES = [((32, 56, 56, 64, 64), 3), ((32, 28, 28, 128, 128), 4),
               ((32, 14, 14, 256, 256), 6), ((32, 7, 7, 512, 512), 3)]
# Ragged tiles (H, W not multiples of the 16x8 tile), channel counts that
# are not multiples of the 32-channel chunk or the 64-channel block, an odd
# Co, a Ci below the 8-wide vector loads, relu off.
EDGE_SHAPES = [((3, 8, 8, 16, 24), True), ((2, 7, 7, 24, 40), True),
               ((5, 9, 13, 24, 40), False), ((1, 1, 1, 8, 8), True),
               ((3, 17, 9, 32, 72), False), ((2, 5, 3, 3, 5), True),
               ((4, 15, 17, 40, 129), True)]

# Tolerances, relative to the largest |reference| value of the case:
# bf16 -- one bf16 rounding step at the output's magnitude (2^-6 ~ 1.6e-2
#         covers the last-bit differences of two f32 accumulation orders);
# f32  -- summation order only (the kernel and cuDNN with TF32 off both
#         keep full f32 products).
RTOL = {"bfloat16": 1.6e-2, "float32": 1e-4}
# Whole-network logits, fused vs unfused, relative to max |logit|: bf16
# rounds the activation at different points in the two paths through 16
# blocks; f32 differs by summation order only.
LOGIT_RTOL = {"bfloat16": 3e-2, "float32": 1e-4}

# ResNet-50's 53 BatchNorms in training at batch 128: the (N, H, W, C) of
# each input (R = N*H*W rows of C channels) and how many run at that shape.
BN_SHAPES = [((128, 112, 112, 64), 1), ((128, 56, 56, 64), 6),
             ((128, 56, 56, 256), 4), ((128, 28, 28, 128), 8),
             ((128, 28, 28, 512), 5), ((128, 14, 14, 256), 12),
             ((128, 14, 14, 1024), 7), ((128, 7, 7, 512), 6),
             ((128, 7, 7, 2048), 4)]
BN_PER_STEP = sum(n for _, n in BN_SHAPES)       # 53
BN_EDGE_R = (1, 63, 65, 4097)
BN_EDGE_C = (3, 5, 129, 2049)
BN_EPS = 1e-5                   # gluon.nn.BatchNorm's default epsilon
# Backward tolerance of the BatchNorm kernels against their plain
# versions, relative to max |reference| (the JAX suite's own bound for its
# kernel); the forward is held bit for bit.
BN_BWD_RTOL = 2e-4
BN_KERNELS = ("stats", "apply", "bwd_reduce", "bwd_dx")
# Line of each TPU kernel body in mxnet_tpu/pallas_kernels/batchnorm_fused.py.
BN_REPLACES = {"stats": 208, "apply": 219, "bwd_reduce": 230, "bwd_dx": 250}
# f32 operations per element of each BatchNorm kernel (sum and
# exact_sq's split; exact_mul's split; xhat and dy'*xhat; xhat and the dx
# chain): all far below the bytes they move.
BN_OPS = {"stats": 9, "apply": 11, "bwd_reduce": 5, "bwd_dx": 6}
# Training-step checks, f32 with TF32 off, card against the port on the CPU
# (relative to the largest magnitude of the compared tensor). The gradient
# and weight bounds widen to twice the spread between two f32 runs on the
# card (phase_train says why).
TRAIN_RTOL = {"loss": 1e-5, "grad": 1e-3, "param": 1e-5}

# Dense peaks from NVIDIA's data sheets: (bf16 tensor FLOP/s, f32 FLOP/s
# on the CUDA cores, memory bytes/s), matched on the name nvidia-smi gives.
PEAKS = [("H100 PCIe", (756e12, 51e12, 2.0e12)),
         ("H100 NVL", (835e12, 60e12, 3.9e12)),
         ("H200", (989e12, 67e12, 4.8e12)),
         ("H100", (989e12, 67e12, 3.35e12))]


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def peaks(name):
    for key, vals in PEAKS:
        if key in name:
            return key, vals
    raise SystemExit("chip_smoke: no peak table entry for %r" % name)


def bound(shape, dtype_bytes, card):
    """Least time (s) for one fused launch, and which side bounds it:
    ops over the peak for the dtype, bytes (x, w, s, b read once, out
    written once) over the memory rate."""
    N, H, W, Ci, Co = shape
    _, (bf16_peak, f32_peak, bw) = card
    ops = 2.0 * N * H * W * 9 * Ci * Co
    nbytes = dtype_bytes * (N * H * W * (Ci + Co) + 9 * Ci * Co) + 8 * Ci
    t_ops = ops / (bf16_peak if dtype_bytes == 2 else f32_peak)
    t_bytes = nbytes / bw
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def device_ms(torch, fn, iters, warmup=3):
    """Mean device time of fn() in ms. The stream is first held by a
    sleep kernel so that all `iters` launches are queued before the
    timed window opens: host launch overhead stays out of the number."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_case(torch, shape, dtype, seed):
    N, H, W, Ci, Co = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    x = torch.randn(N, H, W, Ci, generator=gen, device=dev).to(dtype)
    s = torch.rand(Ci, generator=gen, device=dev) + 0.5
    b = torch.randn(Ci, generator=gen, device=dev) * 0.1
    w = (torch.randn(3, 3, Ci, Co, generator=gen, device=dev)
         * (2.0 / (9 * Ci)) ** 0.5).to(dtype)
    return x, s, b, w


def bn_bound(shape, kernel, dtype_bytes, card):
    """Least time (s) for one launch of a BatchNorm kernel at (N, H, W, C),
    and which side bounds it: its (R, C) tensors read or written once
    (stats reads x; apply reads x, writes out; bwd_reduce reads x, dy;
    bwd_dx reads x, dy, writes dx) plus its (C,) vectors, over the memory
    rate; BN_OPS f32 operations per element over the f32 peak."""
    _, (_, f32_peak, bw) = card
    C = shape[-1]
    n = int(np.prod(shape))
    big = {"stats": 1, "apply": 2, "bwd_reduce": 2, "bwd_dx": 3}[kernel]
    small = {"stats": 2, "apply": 4, "bwd_reduce": 6, "bwd_dx": 6}[kernel]
    t_bytes = (dtype_bytes * n * big + 4 * C * small) / bw
    t_ops = BN_OPS[kernel] * n / f32_peak
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def bn_case(torch, R, C, dtype, seed, special=False):
    """(x, gamma, beta, dy) for a BatchNorm of R rows and C channels.
    ``special`` makes channel 0 all zeros and channel 1 |mean| >> std, so
    that the single-pass variance cancels and clamps to 0."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(R, C, generator=gen, device="cuda") * 2.0 + 0.5
    if special:
        x[:, 0] = 0.0
        if C > 1:
            x[:, 1] = 1e4 + 1e-3 * x[:, 1]
    g = torch.rand(C, generator=gen, device="cuda") + 0.5
    b = torch.randn(C, generator=gen, device="cuda") * 0.1
    dy = torch.randn(R, C, generator=gen, device="cuda").to(dtype)
    return x.to(dtype), g, b, dy


def same_bits(torch, a, b):
    """Bit equality of two float tensors; a NaN matches any NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = torch.isnan(a.float())
    if not torch.equal(nan, torch.isnan(b.float())):
        return False
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return bool(torch.equal(a.view(view)[~nan], b.view(view)[~nan]))


def max_abs_err(torch, a, b):
    """Largest |a - b| over the entries where the reference is finite."""
    ok = torch.isfinite(b.float())
    if not bool(ok.any().item()):
        return 0.0
    return (a.float() - b.float())[ok].abs().max().item()


def bn_check(torch, x2, g, b, dy, act, backward=True):
    """Each BatchNorm kernel against its plain version on the same inputs
    (the plain statistics and sums feed the later kernels). Returns
    {kernel: (ok, max abs err, max |ref|, bitwise share)}."""
    from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
    res = {}
    mean, var = BNF.stats(x2)
    rm, rv = BNF.stats_reference(x2)
    out = BNF.apply(x2, g, b, rm, rv, BN_EPS, act)
    rout = BNF.apply_reference(x2, g, b, rm, rv, BN_EPS, act)
    torch.cuda.synchronize()
    for name, pairs in (("stats", ((mean, rm), (var, rv))),
                        ("apply", ((out, rout),))):
        ok = all(same_bits(torch, k, r) for k, r in pairs)
        err = max(max_abs_err(torch, k, r) for k, r in pairs)
        res[name] = (ok, err, 0.0, 1.0 if ok else 0.0)
    if not backward:
        return res
    db, dg = BNF.bwd_reduce(x2, dy, g, b, rm, rv, BN_EPS, act)
    rdb, rdg = BNF.bwd_reduce_reference(x2, dy, g, b, rm, rv, BN_EPS, act)
    dx = BNF.bwd_dx(x2, dy, g, b, rm, rv, rdb, rdg, BN_EPS, act)
    rdx = BNF.bwd_dx_reference(x2, dy, g, b, rm, rv, rdb, rdg, BN_EPS, act)
    torch.cuda.synchronize()
    for name, pairs in (("bwd_reduce", ((db, rdb), (dg, rdg))),
                        ("bwd_dx", ((dx, rdx),))):
        ok, err, scale, eq, n = True, 0.0, 0.0, 0, 0
        for k, r in pairs:
            e = max_abs_err(torch, k, r)
            sc = r.float().abs().max().item()
            ok = ok and bool(torch.isfinite(k.float()).all().item()) \
                and e <= BN_BWD_RTOL * sc
            err, scale = max(err, e), max(scale, sc)
            eq += int((k.view(torch.int16 if k.dtype == torch.bfloat16
                              else torch.int32)
                       == r.view(torch.int16 if r.dtype == torch.bfloat16
                                 else torch.int32)).sum().item())
            n += r.numel()
        res[name] = (ok, err, scale, eq / n)
    return res


def phase_env(torch, state):
    from mxnet_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    seconds = _build.build_all()
    wall = time.perf_counter() - t0
    ptxas = {}
    for name in _build.SOURCES:
        lines = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        ptxas[name] = lines
    emit({"phase": "env", "smi": state["smi"],
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "peaks_from": state["card"][0],
          "nvcc_seconds": seconds, "build_wall_s": wall, "ptxas": ptxas})


def phase_kernel(torch, state):
    from mxnet_tpu_torch.kernels import conv_fused as CF
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [(shape, True, True) for shape, _ in RN50_SHAPES] \
        + [(shape, relu, False) for shape, relu in EDGE_SHAPES]
    worst = {}
    failures = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for i, (shape, relu, main) in enumerate(cases):
            x, s, b, w = make_case(torch, shape, dtype, seed=100 + i)
            out = CF.fused_scale_relu_conv3x3(x, s, b, w, relu=relu)
            ref = CF.fused_conv_reference(x, s, b, w, relu=relu)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            ok = bool(torch.isfinite(out).all().item()) \
                and out.shape == ref.shape and out.dtype == ref.dtype \
                and err <= RTOL[dname] * max(scale, 1e-30)
            emit({"phase": "kernel", "kernel": "conv_fused", "dtype": dname,
                  "shape": list(shape), "relu": relu, "max_abs_err": err,
                  "ref_max_abs": scale, "tolerance": RTOL[dname] * scale,
                  "ok": ok})
            if not ok:
                failures.append((dname, shape, relu, err, scale))
            if main:
                worst[dname] = max(worst.get(dname, 0.0), err)
    state["kernel_err"] = worst
    if failures:
        raise AssertionError("conv_fused disagrees with its plain version: "
                             "%s" % failures)
    phase_kernel_bn(torch, state)


def phase_kernel_bn(torch, state):
    """The four training-BatchNorm kernels against their plain versions."""
    cases = [(int(np.prod(shape[:3])), shape[-1], True)
             for shape, _ in BN_SHAPES]
    cases += [(r, c, False) for r in BN_EDGE_R for c in BN_EDGE_C]
    worst = {k: 0.0 for k in BN_KERNELS}
    summary = {}
    failures = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for act in (None, "relu"):
            edge = {k: [True, 0.0, 1.0] for k in BN_KERNELS}
            for i, (R, C, main) in enumerate(cases):
                x2, g, b, dy = bn_case(torch, R, C, dtype, seed=300 + i,
                                       special=not main)
                res = bn_check(torch, x2, g, b, dy, act)
                if main:
                    emit({"phase": "kernel", "kernel": "batchnorm_fused",
                          "dtype": dname, "act": act, "R": R, "C": C,
                          "results": {k: {"ok": v[0], "max_abs_err": v[1],
                                          "ref_max_abs": v[2],
                                          "bitwise_share": v[3]}
                                      for k, v in res.items()}})
                for k, (ok, err, _, eq) in res.items():
                    if not ok:
                        failures.append((dname, act, R, C, k, err))
                    if main and dtype == torch.bfloat16:
                        worst[k] = max(worst[k], err)
                    if not main:
                        edge[k][0] = edge[k][0] and ok
                        edge[k][1] = max(edge[k][1], err)
                        edge[k][2] = min(edge[k][2], eq)
                del x2, g, b, dy
            # an inf entry: NaN statistics, forward bit for bit
            x2, g, b, dy = bn_case(torch, 65, 129, dtype, seed=399)
            x2[32, 64] = float("inf")
            res = bn_check(torch, x2, g, b, dy, act, backward=False)
            for k, (ok, err, _, _) in res.items():
                edge[k][0] = edge[k][0] and ok
                if not ok:
                    failures.append((dname, act, 65, 129, k + "+inf", err))
            summary["%s,act=%s" % (dname, act)] = {
                k: {"ok": v[0], "max_abs_err": v[1], "min_bitwise_share":
                    v[2]} for k, v in edge.items()}
    emit({"phase": "kernel", "kernel": "batchnorm_fused",
          "edge_shapes": {"R": BN_EDGE_R, "C": BN_EDGE_C,
                          "plus": "zero channel, clamped variance, inf"},
          "results": summary,
          "tolerance": {"forward": "bitwise", "backward_rtol": BN_BWD_RTOL}})
    state["bn_err"] = worst
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("batchnorm_fused disagrees with its plain "
                             "version: %s" % failures[:20])


def _build_net(mx, arrays, fuse, dtype, ctx):
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    import torch
    net = resnet50_v1(layout="NHWC", fuse=fuse)
    net.initialize(ctx=ctx)
    # the first forward finishes the deferred shapes; then real weights
    net(torch.zeros(1, 3, 224, 224, device=ctx.device))
    mx.convert.load_numpy_params(net, arrays)
    net.cast(dtype)
    return net


def _arrays(mx, state):
    """ResNet-50's weights and running statistics from numpy seed 0, keyed
    by structural name (the same keys with fuse True and False)."""
    if "arrays" not in state:
        import torch
        from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
        probe = resnet50_v1(layout="NHWC", fuse=True)
        probe.initialize(ctx=mx.cpu())
        probe(torch.zeros(1, 3, 224, 224))
        state["arrays"] = mx.convert.random_numpy_params(
            mx.convert.param_shapes(probe), seed=0)
    return state["arrays"]


def phase_serve(torch, state):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import conv_fused as CF

    arrays = _arrays(mx, state)
    gpu = mx.gpu(0)
    rs = np.random.RandomState(1)
    requests = [rs.rand(32, 3, 224, 224).astype("float32") for _ in range(4)]

    # -- the main path: bf16, fused --------------------------------------
    net = _build_net(mx, arrays, True, "bfloat16", gpu)
    ref_net = _build_net(mx, arrays, False, "bfloat16", gpu)
    torch.cuda.synchronize()
    CF.LAUNCHES = 0
    answers, logits = [], []
    for req in requests:
        out = net(torch.from_numpy(req).to("cuda", torch.bfloat16))
        logits.append(out)
        answers.append(torch.topk(out.float(), 5).indices.tolist())
    torch.cuda.synchronize()
    launches = CF.LAUNCHES
    state.setdefault("launches", {})["conv_fused"] = launches
    if launches != 16 * len(requests):
        raise AssertionError("conv_fused launched %d times for %d forwards "
                             "(want 16 each)" % (launches, len(requests)))
    worst, scale, top1 = 0.0, 0.0, 0
    for req, out in zip(requests, logits):
        if tuple(out.shape) != (32, 1000) or \
                not bool(torch.isfinite(out).all().item()):
            raise AssertionError("bad logits %s" % (tuple(out.shape),))
        ref = ref_net(torch.from_numpy(req).to("cuda", torch.bfloat16))
        worst = max(worst, (out.float() - ref.float()).abs().max().item())
        scale = max(scale, ref.float().abs().max().item())
        top1 += int((out.float().argmax(1) == ref.float().argmax(1))
                    .sum().item())
    ok16 = worst <= LOGIT_RTOL["bfloat16"] * scale
    emit({"phase": "serve", "dtype": "bfloat16", "requests": len(requests),
          "batch": 32, "launches": launches,
          "top5_first_image": answers[0][0],
          "max_abs_diff_vs_unfused": worst, "logit_max_abs": scale,
          "tolerance": LOGIT_RTOL["bfloat16"] * scale,
          "top1_agree": top1 / (32.0 * len(requests)), "ok": ok16})
    del net, ref_net, logits

    # -- once more in f32, TF32 off --------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = _build_net(mx, arrays, True, "float32", gpu)
    ref_net = _build_net(mx, arrays, False, "float32", gpu)
    x = torch.from_numpy(requests[0]).cuda()
    before = CF.LAUNCHES
    out = net(x)
    torch.cuda.synchronize()
    n32 = CF.LAUNCHES - before
    ref = ref_net(x)
    err32 = (out - ref).abs().max().item()
    scale32 = ref.abs().max().item()
    cpu_net = _build_net(mx, arrays, False, "float32", mx.cpu())
    cpu_ref = cpu_net(torch.from_numpy(requests[0][:2]))
    err_cpu = (out[:2].cpu() - cpu_ref).abs().max().item()
    ok32 = n32 == 16 and bool(torch.isfinite(out).all().item()) \
        and err32 <= LOGIT_RTOL["float32"] * scale32 \
        and err_cpu <= LOGIT_RTOL["float32"] * scale32
    emit({"phase": "serve", "dtype": "float32", "batch": 32,
          "launches": n32, "max_abs_diff_vs_unfused": err32,
          "max_abs_diff_vs_cpu_port": err_cpu, "logit_max_abs": scale32,
          "tolerance": LOGIT_RTOL["float32"] * scale32, "ok": ok32})
    if not (ok16 and ok32):
        raise AssertionError("serving logits out of tolerance")


def _bn_counts(BNF):
    return {"stats": BNF.LAUNCHES_STATS, "apply": BNF.LAUNCHES_APPLY,
            "bwd_reduce": BNF.LAUNCHES_BWD_REDUCE,
            "bwd_dx": BNF.LAUNCHES_BWD_DX,
            "finalize": BNF.LAUNCHES_FINALIZE, "copies": BNF.COPIES}


def _zero_counts(BNF, CF):
    BNF.LAUNCHES_STATS = BNF.LAUNCHES_APPLY = 0
    BNF.LAUNCHES_BWD_REDUCE = BNF.LAUNCHES_BWD_DX = 0
    BNF.LAUNCHES_FINALIZE = BNF.COPIES = 0
    CF.LAUNCHES = 0


def _train_step(mx, net, trainer, loss_fn, x, y):
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def phase_train(torch, state):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
    from mxnet_tpu_torch.kernels import conv_fused as CF

    arrays = _arrays(mx, state)
    rs = np.random.RandomState(1)
    x_np = rs.rand(128, 3, 224, 224).astype("float32")
    y_np = rs.randint(0, 1000, (128,)).astype("float32")
    loss_fn = SoftmaxCrossEntropyLoss()
    sgd = {"learning_rate": 0.01, "momentum": 0.9}

    # -- the main path: bf16, batch 128, 5 steps on one batch -------------
    net = _build_net(mx, arrays, False, "bfloat16", mx.gpu(0))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(sgd))
    x = torch.from_numpy(x_np).to("cuda", torch.bfloat16)
    y = torch.from_numpy(y_np).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(BNF, CF)
    losses = []
    t0 = time.perf_counter()
    for _ in range(5):
        loss = _train_step(mx, net, trainer, loss_fn, x, y)
        losses.append(loss.detach().float().mean().item())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _bn_counts(BNF)
    conv = CF.LAUNCHES
    want = {k: 5 * BN_PER_STEP for k in BN_KERNELS}
    want["finalize"] = 2 * 5 * BN_PER_STEP
    ok_counts = all(counts[k] == n for k, n in want.items()) and conv == 0
    ok_loss = all(np.isfinite(losses)) and losses[-1] < losses[0]
    state.setdefault("launches", {}).update(
        {k: counts[k] for k in BN_KERNELS})
    state["train"] = {"net": net, "trainer": trainer, "x": x, "y": y}
    emit({"phase": "train", "dtype": "bfloat16", "batch": 128, "steps": 5,
          "losses": losses, "launches": counts, "launches_wanted": want,
          "conv_fused_launches": conv,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "wall_s": wall, "ok": ok_counts and ok_loss})
    if not ok_counts:
        raise AssertionError("training launches %s (conv_fused %d), want %s"
                             % (counts, conv, want))
    if not ok_loss:
        raise AssertionError("training loss not finite and falling: %s"
                             % losses)

    # -- f32, TF32 off: one step at batch 4, the card against the CPU -----
    # The gradients of this deep net at batch 4 are ill-conditioned: any two
    # correct f32 implementations differ by several percent in some layers.
    # So the card is also run with cuDNN off (PyTorch's own convolutions),
    # and the card-vs-CPU gap of the gradients and updated weights must stay
    # within twice that card-vs-card spread (and never needs to beat the
    # stated bounds of TRAIN_RTOL).
    runs = {}
    with mx.precision.matmul_precision("float32"):
        for name, ctx, cudnn in (("card", mx.gpu(0), True),
                                 ("card_native_conv", mx.gpu(0), False),
                                 ("cpu", mx.cpu(), True)):
            prev = torch.backends.cudnn.enabled
            torch.backends.cudnn.enabled = cudnn
            try:
                runs[name] = _f32_step(torch, mx, arrays, ctx, x_np[:4],
                                       y_np[:4], loss_fn, sgd)
            finally:
                torch.backends.cudnn.enabled = prev
    gap = {w: _max_rel(runs["card"], runs["cpu"], w) for w in TRAIN_RTOL}
    spread = {w: _max_rel(runs["card"], runs["card_native_conv"], w)
              for w in TRAIN_RTOL}
    bound = {"loss": TRAIN_RTOL["loss"]}
    for w in ("grad", "param"):
        bound[w] = max(TRAIN_RTOL[w], 2.0 * spread[w][0])
    ok = all(gap[w][0] <= bound[w] for w in TRAIN_RTOL)
    emit({"phase": "train", "dtype": "float32", "batch": 4,
          "card_vs_cpu_max_rel": gap,
          "card_vs_card_native_conv_max_rel": spread,
          "bound_rel": bound, "stated_rel": TRAIN_RTOL,
          "loss": runs["card"]["loss"].tolist(), "ok": ok})
    if not ok:
        raise AssertionError("f32 training step, card vs CPU: %s over %s"
                             % (gap, bound))


def _f32_step(torch, mx, arrays, ctx, x_np, y_np, loss_fn, sgd):
    """One f32 training step from the seed weights on ``ctx``: the
    per-sample loss, every gradient, and every parameter and running
    statistic after the update, on the host."""
    net = _build_net(mx, arrays, False, "float32", ctx)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(sgd))
    dev = ctx.device
    loss = _train_step(mx, net, trainer, loss_fn,
                       torch.from_numpy(x_np).to(dev),
                       torch.from_numpy(y_np).to(dev))
    params = net._collect_params_with_prefix()
    return {"loss": loss.detach().cpu(),
            "grad": {k: p.grad().cpu() for k, p in params.items()
                     if p.grad_req != "null"},
            "param": {k: p.data().detach().cpu()
                      for k, p in params.items()}}


def _max_rel(a, b, what):
    """Largest |a - b| / max|b| over the tensors of ``what``, and where."""
    pairs = [("loss", a["loss"], b["loss"])] if what == "loss" \
        else [(k, a[what][k], b[what][k]) for k in b[what]]
    worst = (0.0, None)
    for key, u, v in pairs:
        rel = (u - v).abs().max().item() / max(v.abs().max().item(), 1e-30)
        worst = max(worst, (rel, key), key=lambda t: t[0])
    return worst


def phase_time(torch, state):
    import mxnet_tpu_torch as mx
    import torch.nn.functional as tF
    from mxnet_tpu_torch.kernels import conv_fused as CF

    card = state["card"]
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "bound_ms": 0.0, "bound_ops_ms": 0.0}
    for i, (shape, count) in enumerate(RN50_SHAPES):
        x, s, b, w = make_case(torch, shape, torch.bfloat16, seed=200 + i)
        sb, bb = s.to(torch.bfloat16), b.to(torch.bfloat16)
        x_cf = x.permute(0, 3, 1, 2)                       # channels-last
        w_cl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def library():
            z = torch.relu(x_cf * sb.view(1, -1, 1, 1) + bb.view(1, -1, 1, 1))
            return tF.conv2d(z, w_cl, padding=1)

        def conv_only():
            return tF.conv2d(x_cf, w_cl, padding=1)

        k_ms = device_ms(torch, lambda: CF.fused_scale_relu_conv3x3(
            x, s, b, w), iters=50)
        p_ms = device_ms(torch, lambda: CF.fused_conv_reference(
            x, s, b, w), iters=10)
        l_ms = device_ms(torch, library, iters=20)
        c_ms = device_ms(torch, conv_only, iters=20)
        t_bound, by = bound(shape, 2, card)
        b_ms = t_bound * 1e3
        emit({"phase": "time", "kernel": "conv_fused", "dtype": "bfloat16",
              "shape": list(shape), "launches_per_forward": count,
              "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
              "cudnn_conv_only_ms": c_ms, "bound_ms": b_ms, "bound_by": by,
              "roofline_share": b_ms / k_ms})
        totals["ms"] += count * k_ms
        totals["plain_ms"] += count * p_ms
        totals["library_ms"] += count * l_ms
        totals["bound_ms"] += count * b_ms
        if by == "operations":
            totals["bound_ops_ms"] += count * b_ms
    totals["bound_by"] = "operations" \
        if totals["bound_ops_ms"] >= totals["bound_ms"] / 2 else "bytes"
    state["timing"] = totals

    # whole forward, bf16, fused and unfused, batch resident on the card:
    # host wall clock (what an eager caller sees) and, from the profiler,
    # the device's busy time per forward and its idle share
    arrays = state["arrays"]
    rates = {}
    for fuse in (True, False):
        net = _build_net(mx, arrays, fuse, "bfloat16", mx.gpu(0))
        for batch, iters in ((32, 20), (256, 5)):
            x = torch.rand(batch, 3, 224, 224, device="cuda",
                           dtype=torch.bfloat16)
            for _ in range(3):
                net(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                net(x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            busy_ms, by_kernel, ops = profile_busy_ms(
                torch, lambda: net(x), 3, top=10 if batch == 32 else None,
                match="conv_fused")
            rates["fuse=%s,b%d" % (fuse, batch)] = {
                "images_per_sec": batch * iters / wall,
                "wall_ms_per_forward": wall / iters * 1e3,
                "device_busy_ms_per_forward": busy_ms,
                "device_idle_share": None if busy_ms is None
                else max(0.0, 1.0 - busy_ms / (wall / iters * 1e3)),
                "conv_fused_ms_per_forward": by_kernel}
            if ops:
                emit({"phase": "time", "where_the_time_goes":
                      "fuse=%s,b%d" % (fuse, batch), "top_ops": ops})
        del net
    emit({"phase": "time", "resnet50_v1_nhwc_bf16": rates})
    phase_time_bn(torch, state)
    phase_time_train(torch, state)


def phase_time_bn(torch, state):
    """Each BatchNorm kernel at the nine training shapes (bf16, act None):
    kernel, plain version and library call, beside the bound."""
    import torch.nn.functional as tF
    from mxnet_tpu_torch.kernels import batchnorm_fused as BNF

    card = state["card"]
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0, "bound_ops_ms": 0.0} for k in BN_KERNELS}
    pair_lib = {"forward": 0.0, "backward": 0.0}
    for i, (shape, count) in enumerate(BN_SHAPES):
        N, H, W, C = shape
        R = N * H * W
        x2, g, b, dy = bn_case(torch, R, C, torch.bfloat16, seed=500 + i)
        mean, var = BNF.stats_reference(x2)
        db, dg = BNF.bwd_reduce_reference(x2, dy, g, b, mean, var, BN_EPS)
        inv = BNF.inv_std(var, BN_EPS)
        x_cf = x2.view(N, H, W, C).permute(0, 3, 1, 2)   # channels-last
        dy_cf = dy.view(N, H, W, C).permute(0, 3, 1, 2)
        bwd = torch.ops.aten.native_batch_norm_backward
        runs = {
            "stats": (lambda: BNF.stats(x2),
                      lambda: BNF.stats_reference(x2),
                      lambda: torch.var_mean(x_cf, dim=(0, 2, 3),
                                             correction=0)),
            "apply": (lambda: BNF.apply(x2, g, b, mean, var, BN_EPS),
                      lambda: BNF.apply_reference(x2, g, b, mean, var,
                                                  BN_EPS),
                      lambda: tF.batch_norm(x_cf, mean, var, g, b,
                                            training=False, eps=BN_EPS)),
            "bwd_reduce": (
                lambda: BNF.bwd_reduce(x2, dy, g, b, mean, var, BN_EPS),
                lambda: BNF.bwd_reduce_reference(x2, dy, g, b, mean, var,
                                                 BN_EPS),
                lambda: bwd(dy_cf, x_cf, g, None, None, mean, inv, True,
                            BN_EPS, [False, True, True])),
            "bwd_dx": (
                lambda: BNF.bwd_dx(x2, dy, g, b, mean, var, db, dg, BN_EPS),
                lambda: BNF.bwd_dx_reference(x2, dy, g, b, mean, var, db,
                                             dg, BN_EPS),
                lambda: bwd(dy_cf, x_cf, g, None, None, mean, inv, True,
                            BN_EPS, [True, False, False])),
        }
        row = {}
        for k, (kern, plain, lib) in runs.items():
            t_bound, by = bn_bound(shape, k, 2, card)
            row[k] = {"ms": device_ms(torch, kern, iters=20),
                      "plain_ms": device_ms(torch, plain, iters=3, warmup=1),
                      "library_ms": device_ms(torch, lib, iters=20),
                      "bound_ms": t_bound * 1e3, "bound_by": by}
            row[k]["roofline_share"] = row[k]["bound_ms"] / row[k]["ms"]
            for f in ("ms", "plain_ms", "library_ms", "bound_ms"):
                totals[k][f] += count * row[k][f]
            if by == "operations":
                totals[k]["bound_ops_ms"] += count * row[k]["bound_ms"]
        fwd_lib = device_ms(torch, lambda: tF.batch_norm(
            x_cf, None, None, g, b, training=True, eps=BN_EPS), iters=20)
        bwd_lib = device_ms(torch, lambda: bwd(
            dy_cf, x_cf, g, None, None, mean, inv, True, BN_EPS,
            [True, True, True]), iters=20)
        pair_lib["forward"] += count * fwd_lib
        pair_lib["backward"] += count * bwd_lib
        emit({"phase": "time", "kernel": "batchnorm_fused",
              "dtype": "bfloat16", "shape_nhwc": list(shape), "R": R,
              "C": C, "launches_per_step": count, "kernels": row,
              "library_forward_ms": fwd_lib, "library_backward_ms": bwd_lib})
        del x2, g, b, dy, x_cf, dy_cf
    for k in BN_KERNELS:
        t = totals[k]
        t["bound_by"] = "operations" \
            if t.pop("bound_ops_ms") >= t["bound_ms"] / 2 else "bytes"
    state["bn_timing"] = totals
    emit({"phase": "time", "kernel": "batchnorm_fused",
          "per_step_bf16_b128": totals,
          "library_per_step_ms": {
              "forward_batch_norm_training": pair_lib["forward"],
              "backward_native_batch_norm_backward": pair_lib["backward"]}})
    torch.cuda.empty_cache()


def phase_time_train(torch, state):
    """The training step at batch 128 in bf16: images/sec from wall time,
    device busy time and idle share, and the top host ops by device
    time."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    t = state.get("train")
    if t is None:
        return
    loss_fn = SoftmaxCrossEntropyLoss()

    def step():
        _train_step(mx, t["net"], t["trainer"], loss_fn, t["x"], t["y"])

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / iters
    busy_ms, bn_ms, ops = profile_busy_ms(torch, step, 2, top=12,
                                          match="bn_")
    emit({"phase": "time", "train_step_resnet50_v1_nhwc_bf16_b128": {
        "images_per_sec": 128 / wall, "wall_ms_per_step": wall * 1e3,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": None if busy_ms is None
        else max(0.0, 1.0 - busy_ms / (wall * 1e3)),
        "batchnorm_kernels_ms_per_step": bn_ms}})
    if ops:
        emit({"phase": "time", "where_the_time_goes": "train_step,b128",
              "top_ops": ops})


def _self_device_us(ev):
    us = getattr(ev, "self_device_time_total", None)
    return getattr(ev, "self_cuda_time_total", 0.0) if us is None else us


def profile_busy_ms(torch, fn, iters, top=None, match="conv_fused"):
    """From torch.profiler: device time per call of fn() summed over its
    kernels, the part spent in kernels whose name contains `match`, and
    (with `top`) the host ops whose kernels took the most device time.
    (None, None, []) where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = fused = 0.0
    by_op = []
    for ev in prof.key_averages():
        us = _self_device_us(ev)
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            if us > 0:                  # a host op, by its kernels' time
                by_op.append((us, ev.key))
            continue
        total += us
        if match in ev.key:
            fused += us
    if total <= 0:
        return None, None, []
    ops = [{"op": key[:60], "ms_per_call": us / iters / 1e3,
            "share": us / total} for us, key in sorted(by_op)[::-1][:top]] \
        if top else []
    return total / iters / 1e3, fused / iters / 1e3, ops


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error("unknown phases %s" % sorted(unknown))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    try:
        import mxnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print("chip_smoke: run from a checkout of the repository (%s)" % e,
              file=sys.stderr)
        return 2

    line = smi()
    state = {"smi": line, "card": peaks(line.split(",")[0])}
    for p in PHASES:
        if p in phases:
            globals()["phase_" + p](torch, state)

    print(line, flush=True)
    if all(p in phases for p in ("kernel", "serve", "train", "time")):
        t = state["timing"]
        kernels = [{
            "name": "conv_fused", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/conv_fused.cu",
            "replaces": "mxnet_tpu/pallas_kernels/conv_fused.py:121",
            "launches": state["launches"]["conv_fused"],
            "max_abs_err": state["kernel_err"]["bfloat16"],
            "tolerance": RTOL["bfloat16"],
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "per": "one ResNet-50 forward at batch 32, bf16 (16 launches)",
        }]
        for k in BN_KERNELS:
            b = state["bn_timing"][k]
            kernels.append({
                "name": "batchnorm_fused." + k, "route": "cuda",
                "source": "mxnet_tpu_torch/csrc/batchnorm_fused.cu",
                "replaces": "mxnet_tpu/pallas_kernels/batchnorm_fused.py:%d"
                % BN_REPLACES[k],
                "launches": state["launches"][k],
                "max_abs_err": state["bn_err"][k],
                "tolerance": 0.0 if k in ("stats", "apply") else BN_BWD_RTOL,
                "ms": b["ms"], "kernel_ms": b["ms"],
                "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"], "library_ms": b["library_ms"],
                "per": "one ResNet-50 training step at batch 128, bf16 "
                       "(%d launches%s)" % (BN_PER_STEP, "" if k in (
                           "apply", "bwd_dx") else " and %d finalize "
                           "launches" % BN_PER_STEP),
            })
        emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

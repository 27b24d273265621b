#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase (needs one GPU)
    python3 chip_smoke.py --phases env,kernel

Phases, each printing JSON lines:

1. env     -- card name and power limit, torch/CUDA versions, and the nvcc
              build of every kernel source in mxnet_tpu_torch/csrc/.
2. kernel  -- each kernel against its plain PyTorch version on the card, at
              the shapes ResNet-50 gives it (batch 32) and at edge shapes,
              in bf16 and f32.
3. serve   -- the main path: resnet50_v1(layout="NHWC", fuse=True) in bf16
              answers 4 requests of 32 images (top-5 classes each). Launch
              counters are zeroed just before and read just after; every
              fused link must have gone through its kernel. Logits are
              checked against the same weights run with fuse=False (no
              kernel), then once more in f32 with TF32 off, and against the
              port on the CPU for two images.
4. time    -- CUDA-event times per kernel shape (kernel, plain version,
              cuDNN yardstick) beside the card's bound, and whole-forward
              images/sec at batch 32 and 256 in bf16.

The run ends with the nvidia-smi name/power line, then the
{"kernels": [...]} line (per kernel: launches on the main path, max abs
error at the ResNet-50 shapes in bf16 and its tolerance as a fraction of
max |reference|, and the times of one batch-32 forward's launches), then
{"ok": true, "device": {...}} as the last line. Any failure exits
non-zero before them.
Weights and data are drawn from fixed seeds; nothing is downloaded.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

PHASES = ("env", "kernel", "serve", "time")

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


def phase_serve(torch, state):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import conv_fused as CF
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    probe = resnet50_v1(layout="NHWC", fuse=True)
    probe.initialize(ctx=mx.cpu())
    probe(torch.zeros(1, 3, 224, 224))
    arrays = mx.convert.random_numpy_params(mx.convert.param_shapes(probe),
                                            seed=0)
    state["arrays"] = arrays
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
    state["launches"] = {"conv_fused": launches}
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
                torch, lambda: net(x), 3, top=10 if batch == 32 else None)
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


def _self_device_us(ev):
    us = getattr(ev, "self_device_time_total", None)
    return getattr(ev, "self_cuda_time_total", 0.0) if us is None else us


def profile_busy_ms(torch, fn, iters, top=None):
    """From torch.profiler: device time per call of fn() summed over its
    kernels, the part spent in the conv_fused kernels, and (with `top`)
    the host ops whose kernels took the most device time. (None, None, [])
    where the profiler saw no device time."""
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
        if "conv_fused" in ev.key:
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
    if "time" in phases and "serve" in phases and "kernel" in phases:
        t = state["timing"]
        emit({"kernels": [{
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
        }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

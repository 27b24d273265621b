"""Does torch.profiler see every launch late in a long run? On one card.

    python3 chip_profile_probe.py

Builds the kernels (phase env of chip_smoke.py), then times the grouped
2-bit codec over ResNet-50's 54 compressed gradients (bf16, threshold 0.5,
the inputs of chip_smoke.py's time_codec) and, by CUDA events only, a
102-MB float32 copy, before and after phase zoo (minutes of heavy profiler
windows), and prints one JSON line each time: per codec kernel, the events
a plain 10-call profiler window recorded ("prof": count and device us), the
same calls' time by CUDA events ("events_ms", the stream held by a sleep
kernel), chip_smoke.kernel_ms of the quantize kernel, and whether the
quantized words and residuals equal the plain version's bit for bit. A
count below 10 with unchanged events_ms and bits is an event the profiler
lost, not a faster kernel.

    python3 chip_profile_probe.py --windows

instead asks which launches a window loses and why: in windows of the
grouped codec (10 calls, one launch each) and of 400 small elementwise
launches a call (5 calls), with 0, 0.05 and 0.5 s of idle host time at
each end, it pairs each launch call on the host with its device event by
correlation id and prints the launches, the device events, the launches
with no device event and where in the window they sat, and the least and
largest delay from a launch call to its kernel's start. It does so at the
start, after 60 s without profiling, and after 20 windows of 20,000
launches each."""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402


def prof(torch, fn, iters, name):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in p.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            us = cs._self_device_us(ev)
            if name in ev.key:
                out = {"count": ev.count, "us_total": us}
    return out


def events(torch, fn, iters):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def codec(torch, mx, state, tag):
    from mxnet_tpu_torch.kernels import compression as C
    sizes = cs._kv_sizes(mx, state)
    thr = 0.5
    gen = torch.Generator(device="cuda").manual_seed(1500)
    gs = [(torch.randn(n, generator=gen, device="cuda") * 0.4)
          .to(torch.bfloat16) for n in sizes]
    rs = [(torch.randn(n, generator=gen, device="cuda") * 0.1)
          .to(torch.bfloat16) for n in sizes]
    words, newr = C.quantize_2bit_group(gs, rs, thr)
    ref = C.quantize_2bit_group_reference(gs, rs, thr)
    bits = all(torch.equal(a, b) for a, b in zip(words, ref[0])) and all(
        torch.equal(a.view(torch.int16), b.view(torch.int16))
        for a, b in zip(newr, ref[1]))
    q = lambda: C.quantize_2bit_group(gs, rs, thr)  # noqa: E731
    d = lambda: C.dequantize_2bit_group(words, sizes, thr)  # noqa: E731
    big = torch.empty(sum(sizes), dtype=torch.float32, device="cuda")
    big2 = torch.empty_like(big)
    cp = lambda: big2.copy_(big)  # noqa: E731
    res = {"tag": tag, "bits": bits,
           "quantize": {"prof": prof(torch, q, 10, "codec_quantize"),
                        "events_ms": events(torch, q, 10)},
           "dequantize": {"prof": prof(torch, d, 10, "codec_dequantize"),
                          "events_ms": events(torch, d, 10)},
           "copy_f32": {"prof": prof(torch, cp, 10, "elementwise"),
                        "events_ms": events(torch, cp, 10)},
           "kernel_ms_q": cs.kernel_ms(torch, q, 10,
                                       {"k": ("codec_quantize_kernel",)}),
           "mem_alloc_gb": torch.cuda.memory_allocated() / 1e9,
           "mem_reserved_gb": torch.cuda.memory_reserved() / 1e9}
    print(json.dumps(res), flush=True)
    del gs, rs, words, newr, ref, big, big2
    torch.cuda.empty_cache()


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def window(torch, fn, iters, pad):
    """One profiler window of `iters` calls of fn() with `pad` s of idle
    host time at each end: launches against device events by correlation
    id."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        time.sleep(pad)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    evs = p.profiler.kineto_results.events()
    start = p.profiler.kineto_results.trace_start_ns()
    launches = {e.correlation_id(): e for e in evs
                if str(e.device_type()).endswith("CPU")
                and e.name() in LAUNCH_CALLS}
    kernels = {e.correlation_id(): e for e in evs
               if str(e.device_type()).endswith("CUDA")}
    delays = [(kernels[c].start_ns() - e.start_ns()) / 1e6
              for c, e in launches.items() if c in kernels]
    lost = sorted(e.start_ns() for c, e in launches.items()
                  if c not in kernels)
    t = sorted(e.start_ns() for e in launches.values())
    span = (t[-1] - t[0]) if len(t) > 1 else 1
    return {"pad_s": pad, "launches": len(launches),
            "device_events": len(kernels),
            "lost": len(lost),
            "lost_at_share_of_window": [round((x - t[0]) / span, 3)
                                        for x in lost[:3] + lost[-3:]],
            "delay_ms_min": min(delays) if delays else None,
            "delay_ms_max": max(delays) if delays else None,
            "first_launch_after_trace_start_ms": (t[0] - start) / 1e6
            if t else None}


def windows(torch, mx, state, tag):
    from mxnet_tpu_torch.kernels import compression as C
    sizes = cs._kv_sizes(mx, state)
    gen = torch.Generator(device="cuda").manual_seed(1500)
    gs = [(torch.randn(n, generator=gen, device="cuda") * 0.4)
          .to(torch.bfloat16) for n in sizes]
    rs = [(torch.randn(n, generator=gen, device="cuda") * 0.1)
          .to(torch.bfloat16) for n in sizes]
    x = torch.zeros(4096, device="cuda")

    def small():
        for _ in range(400):
            x.add_(1.0)
    q = lambda: C.quantize_2bit_group(gs, rs, 0.5)  # noqa: E731
    q()
    small()
    torch.cuda.synchronize()
    res = {"tag": tag, "elapsed_s": time.perf_counter() - T0}
    for name, fn, iters in (("codec", q, 10), ("small", small, 5)):
        res[name] = [window(torch, fn, iters, pad) for pad in (0, 0.05, 0.5)]
    print(json.dumps(res), flush=True)
    del gs, rs
    torch.cuda.empty_cache()


def main_windows(torch, mx, state):
    windows(torch, mx, state, "start")
    time.sleep(60)
    windows(torch, mx, state, "after_60s_idle")
    x = torch.zeros(4096, device="cuda")
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    for _ in range(20):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            for _ in range(20000):
                x.add_(1.0)
            torch.cuda.synchronize()
        p.key_averages()
    print(json.dumps({"heavy_windows_s": time.perf_counter() - t0}),
          flush=True)
    windows(torch, mx, state, "after_heavy_windows")
    return 0


T0 = time.perf_counter()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_profile_probe: no CUDA device", file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx
    line = cs.smi()
    print(line, flush=True)
    state = {"smi": line, "card": cs.peaks(line.split(",")[0])}
    cs.phase_env(torch, state)
    if "--windows" in sys.argv[1:]:
        return main_windows(torch, mx, state)
    codec(torch, mx, state, "start")
    cs.phase_zoo(torch, state)
    codec(torch, mx, state, "after_zoo")
    codec(torch, mx, state, "after_zoo2")
    return 0

if __name__ == "__main__":
    sys.exit(main())

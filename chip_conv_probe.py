"""Variants of the bf16 conv_fused forward kernel, checked and timed on the card.

Each variant is ``mxnet_tpu_torch/csrc/conv_fused.cu`` with named edits of
the forward kernel's region, built with the port's nvcc flags into
``mxnet_tpu_torch/_build/probe/conv/``. A variant that keeps the function
is checked against the plain version at ResNet-50's four fused serving
shapes (batch 32), within chip_smoke.py's bf16 tolerance and with the same
bits on a second launch; the ablations (marked below) compute something
else and are only timed. Each variant then times the four shapes (CUDA
events over 50 launches, twice) in a process of its own, in turns (the
list, then the list reversed), and prints the total per b32 forward (the
shapes weighted by their launches: 3, 4, 6, 3).

    python3 chip_conv_probe.py [variant ...]      (default: all)
    python3 chip_conv_probe.py --sources DIR      (write the sources)

Variants:
  as_is          the source as it is;
  trace          as_is, and in block 0 the first thread of each consumer
                 warpgroup stamps clock64() around each wait and issue of
                 every tap, chunk and epilogue, the producer around each
                 wait for an empty slot or stage, and the first activator
                 around each halo's wait, passes and arrival; the worker
                 prints the mean cycles of each step per shape;
  depth2, depth3 two or three tap groups in flight per consumer (as_is:
                 one);
  batch1, batch5 the activators' passes one at a time or in batches of 5
                 (as_is: 3; at 5 the activators' 56 registers spill);
ablations (timed only):
  no_act         the halo activation's passes left out;
  no_store       the epilogue's TMA stores left out.

It needs one CUDA device and imports nothing of JAX.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "mxnet_tpu_torch", "csrc")
SOURCE = "conv_fused.cu"
# The forward kernel's region of the source: an edit changes only it.
START = "// Forward, bf16: persistent"
END = "// f32: CUDA cores"
# ResNet-50's fused serving shapes at batch 32 and launches per forward.
SHAPES = [((32, 56, 56, 64, 64), 3), ((32, 28, 28, 128, 128), 4),
          ((32, 14, 14, 256, 256), 6), ((32, 7, 7, 512, 512), 3)]
TIMED_ONLY = ("no_act", "no_store")
# Trace slots per row: tap step t of a block's walk in 10 t .. 10 t + 9.
TRACE_N = 8192
# Stamp pairs (first event, second event) of each traced step.
CONSUMER_STEPS = {"piece_wait": (0, 1), "issue": (1, 2), "group_wait": (2, 3),
                  "ready_wait": (6, 7), "epilogue": (8, 9)}
PRODUCER_STEPS = {"slot_wait": (0, 1), "stage_wait_c0": (6, 7),
                  "stage_wait_c1": (8, 9)}
ACTIVATOR_STEPS = {"halo_wait": (0, 1), "passes": (1, 2), "fence_arrive": (2, 3)}

TRACE_DEFS = r"""__device__ long long fwb_trace[4][%d];
#define FWB_MARK(slot, k)                                              \
  do {                                                                 \
    if (blockIdx.x == 0 && ((threadIdx.x & 127) == 0 ||                \
                            threadIdx.x == 288) &&                     \
        (slot) * 10 + (k) < %d)                                        \
      fwb_trace[threadIdx.x == 288 ? 3 : threadIdx.x >> 7]             \
               [(slot) * 10 + (k)] = (clock64() << 4) | (k);           \
  } while (0)
""" % (TRACE_N, TRACE_N)

TRACE_FETCH = r"""extern "C" {

// Copies the trace (4 x n stamps, 0 where none) into dst and clears it.
int conv_fused_probe_trace(long long* dst, int n) {
  static long long zeros[4 * %d];
  cudaMemcpyFromSymbol(dst, fwb_trace, 4 * n * sizeof(long long));
  return static_cast<int>(cudaMemcpyToSymbol(fwb_trace, zeros,
                                             sizeof(zeros)));
}
""" % TRACE_N


def _sub(text, old, new):
    a = text.index(START)
    b = text.index(END, a)
    body = text[a:b]
    if body.count(old) != 1:
        raise ValueError("probe edit does not apply: %r" % old[:60])
    return text[:a] + body.replace(old, new) + text[b:]


def _trace(text):
    """Row 0 and 1 of the stamps are the consumers, row 2 the producer; a
    stamp costs a clock read and a store."""
    text = _sub(text, "constexpr int FWB_THREADS = 384;",
                TRACE_DEFS + "constexpr int FWB_THREADS = 384;")
    # the producer's waits for an empty stage and an empty slot
    text = _sub(text, """        if (q >= 2) mbar_wait(&bb.hempty[stg], ((q - 2) >> 1) & 1);
""", """        FWB_MARK(q * 9, 6 + 2 * cg);
        if (q >= 2) mbar_wait(&bb.hempty[stg], ((q - 2) >> 1) & 1);
        FWB_MARK(q * 9, 7 + 2 * cg);
""")
    text = _sub(text, """        if (p >= walk.w_stages) mbar_wait(&bb.wempty[slot], phase ^ 1);
""", """        FWB_MARK(p, 0);
        if (p >= walk.w_stages) mbar_wait(&bb.wempty[slot], phase ^ 1);
        FWB_MARK(p, 1);
""")
    # the consumers' chunk, tap and epilogue steps
    text = _sub(text, """      mbar_wait(&hready[stg], (q >> 1) & 1);
""", """      FWB_MARK(q * 9, 6);
      mbar_wait(&hready[stg], (q >> 1) & 1);
      FWB_MARK(q * 9, 7);
""")
    text = _sub(text, """        mbar_wait(&wfull[ws], walk.resident ? 0 : phase);
        fwb_group<NB>(acc, da, dxb_bdesc(wring + ws * NB * DXB_BOX), tap);
""", """        FWB_MARK(q * 9 + tap, 0);
        mbar_wait(&wfull[ws], walk.resident ? 0 : phase);
        FWB_MARK(q * 9 + tap, 1);
        fwb_group<NB>(acc, da, dxb_bdesc(wring + ws * NB * DXB_BOX), tap);
        FWB_MARK(q * 9 + tap, 2);
""")
    text = _sub(text, """                     : "memory");
        // the item's group FWB_DEPTH back""", """                     : "memory");
        FWB_MARK(q * 9 + tap, 3);
        // the item's group FWB_DEPTH back""")
    text = _sub(text, """    reg_fence_all(reinterpret_cast<float(&)[2 * NB * 8][4]>(acc));
""", """    reg_fence_all(reinterpret_cast<float(&)[2 * NB * 8][4]>(acc));
    FWB_MARK(q * 9 - 1, 8);
""")
    text = _sub(text, """    if (lane == 0) mbar_arrive(&hempty[stg]);
  }
}""", """    if (lane == 0) mbar_arrive(&hempty[stg]);
    FWB_MARK(q * 9 - 1, 9);
  }
}""")
    # an activator's wait for each halo, its passes, fence and arrival
    text = _sub(text, """        mbar_wait(&bb.hfull[stg], (q >> 1) & 1);
""", """        FWB_MARK(2 * q + cg, 0);
        mbar_wait(&bb.hfull[stg], (q >> 1) & 1);
        FWB_MARK(2 * q + cg, 1);
""")
    text = _sub(text, """        asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
        mbar_arrive(&bb.hready[stg]);
""", """        FWB_MARK(2 * q + cg, 2);
        asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
        mbar_arrive(&bb.hready[stg]);
        FWB_MARK(2 * q + cg, 3);
""")
    return text.replace('extern "C" {\n', TRACE_FETCH, 1)


def _depth(n):
    return lambda text: _sub(text, "constexpr int FWB_DEPTH = 1;",
                             "constexpr int FWB_DEPTH = %d;" % n)


def _batch(n):
    return lambda text: _sub(text, "constexpr int FWB_ACT_BATCH = 3;",
                             "constexpr int FWB_ACT_BATCH = %d;" % n)


def _no_act(text):
    return _sub(text,
                "for (int j0 = 0; j0 < FWB_ACT_J; j0 += FWB_ACT_BATCH) {",
                "for (int j0 = 0; j0 < 0; j0 += FWB_ACT_BATCH) {")


def _no_store(text):
    return _sub(text, """        if (hrow < g.H)
          tma_store4(&tmout, scr + (nb * TH + tr) * 1024,
                     co0 + nb * DXB_CH, c0, hrow, n);
""", "")


VARIANTS = {"as_is": lambda text: text, "trace": _trace,
            "depth2": _depth(2), "depth3": _depth(3), "batch1": _batch(1),
            "batch5": _batch(5), "no_act": _no_act,
            "no_store": _no_store}


def summarize(buf):
    """Mean cycles (and count) of each traced step of block 0: per
    consumer, a tap's wait for its piece, its issue, its wait for the group
    FWB_DEPTH back and the rest until the next tap, a chunk's wait for its
    activated halo and an item's epilogue; for the producer, its waits for
    an empty slot and for each consumer's empty stage; for the first
    activator, its wait for each halo to land, its passes, and its fence
    and arrival. buf holds each row's TRACE_N slots, (cycles << 4) |
    event, 0 where none."""
    out = {}
    for row, name in enumerate(("consumer0", "consumer1", "producer",
                                "activator")):
        slots = buf[row * TRACE_N:(row + 1) * TRACE_N]
        stamp = {i: int(v) >> 4 for i, v in enumerate(slots) if v}
        pairs = (CONSUMER_STEPS, CONSUMER_STEPS, PRODUCER_STEPS,
                 ACTIVATOR_STEPS)[row]
        steps = {k: [] for k in pairs}
        steps["to_next_tap"] = []
        for t in sorted({i // 10 for i in stamp}):
            for k, (e0, e1) in pairs.items():
                a, b = stamp.get(10 * t + e0), stamp.get(10 * t + e1)
                if a is not None and b is not None:
                    steps[k].append(b - a)
            a, b = stamp.get(10 * t + 3), stamp.get(10 * (t + 1))
            if row < 2 and a is not None and b is not None:
                steps["to_next_tap"].append(b - a)
        res = {k: [round(sum(v) / len(v)), len(v)] for k, v in steps.items()
               if v}
        if stamp:
            res["span"] = max(stamp.values()) - min(stamp.values())
        out[name] = res
    return out


def write_sources(names, out_dir):
    """Each variant's source (and the shared header) under
    out_dir/<name>/; returns {name: source path}."""
    with open(os.path.join(CSRC, SOURCE)) as f:
        text = f.read()
    with open(os.path.join(CSRC, "sm90.cuh")) as f:
        header = f.read()
    paths = {}
    for name in names:
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, SOURCE), "w") as f:
            f.write(VARIANTS[name](text))
        with open(os.path.join(d, "sm90.cuh"), "w") as f:
            f.write(header)
        paths[name] = os.path.join(d, SOURCE)
    return paths


def emit(obj):
    print(json.dumps(obj), flush=True)


def build(paths):
    """One nvcc per variant, all at once; returns {name: library path} of
    those that built, printing the forward kernel's ptxas report."""
    from mxnet_tpu_torch.kernels import _build
    procs = {}
    for name, src in paths.items():
        lib = os.path.join(os.path.dirname(src), "lib.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc()] + _build._FLAGS + ["-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        lines = out.splitlines()
        report = [" | ".join(x.strip() for x in lines[i + 1:i + 4]
                             if "Function properties" not in x)
                  for i, ln in enumerate(lines)
                  if "Compiling entry function" in ln
                  and "conv_fused_fwd_bf16" in ln]
        emit({"variant": name, "built": proc.returncode == 0,
              "ptxas_fwd": report,
              "errors": [ln for ln in lines if " error" in ln][:5]})
        if proc.returncode == 0:
            libs[name] = lib
    return libs


def worker(name, lib, check):
    """Checks (once per variant, unless an ablation) and times one
    variant."""
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import conv_fused as CF
    _build._LIBS["conv_fused"] = ctypes.CDLL(lib)
    out = {"variant": name}
    cases = [cs.make_case(torch, shape, torch.bfloat16, 300 + i)
             for i, (shape, _) in enumerate(SHAPES)]
    if check and name not in TIMED_ONLY:
        bad = []
        for (shape, _), (x, s, b, w) in zip(SHAPES, cases):
            got = CF.fused_scale_relu_conv3x3(x, s, b, w)
            again = CF.fused_scale_relu_conv3x3(x, s, b, w)
            ref = CF.fused_conv_reference(x, s, b, w)
            torch.cuda.synchronize()
            err = cs.max_abs_err(torch, got, ref)
            if not (err <= cs.RTOL["bfloat16"] * ref.float().abs().max()
                    .item() and cs.same_bits(torch, got, again)):
                bad.append([list(shape), err])
        out["checks_ok"] = not bad
        out["failures"] = bad
    per = {}
    for (shape, _), (x, s, b, w) in zip(SHAPES, cases):
        key = "x".join(map(str, shape))
        per[key] = min(cs.device_ms(torch, lambda: CF.fused_scale_relu_conv3x3(
            x, s, b, w), iters=50) for _ in range(2))
        if name == "trace":
            fn = _build._LIBS["conv_fused"].conv_fused_probe_trace
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
            fn.restype = ctypes.c_int
            buf = np.zeros(4 * TRACE_N, dtype=np.int64)
            fn(buf.ctypes.data, TRACE_N)   # clears what the timed launches left
            CF.fused_scale_relu_conv3x3(x, s, b, w)
            torch.cuda.synchronize()
            fn(buf.ctypes.data, TRACE_N)
            out.setdefault("trace", {})[key] = summarize(buf)
    out["ms_per_shape"] = per
    out["forward_ms"] = sum(c * per["x".join(map(str, s))]
                            for s, c in SHAPES)
    emit(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--sources", help="write the variants' sources to this "
                    "directory and stop")
    ap.add_argument("--worker", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        name, lib, check = args.worker
        worker(name, lib, check == "1")
        return 0
    names = args.variants or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        ap.error("unknown variants %s" % sorted(unknown))
    if args.sources:
        write_sources(names, args.sources)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_conv_probe: no CUDA device; this probe needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build", "probe",
                           "conv")
    libs = build(write_sources(names, out_dir))
    built = [n for n in names if n in libs]
    rows, ok = {n: [] for n in built}, {}
    for turn in (built, built[::-1]):
        for name in turn:
            if rows[name] and rows[name][0] is None:
                continue                # failed in the first turn
            check = name not in ok
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--worker", name, libs[name],
                                "1" if check else "0"],
                               capture_output=True, text=True, timeout=600)
            lines = [ln for ln in r.stdout.splitlines()
                     if ln.startswith("{")]
            if r.returncode != 0 or not lines:
                emit({"variant": name, "failed": r.returncode,
                      "stderr": r.stderr[-800:]})
                rows[name].append(None)
                ok[name] = False
                continue
            res = json.loads(lines[-1])
            print(lines[-1], flush=True)
            rows[name].append(res["forward_ms"])
            if check:
                ok[name] = res.get("checks_ok", True)
    emit({"smi": smi, "forward_ms_in_turns": rows, "checks_ok": ok})
    return 0 if all(ok.values()) and len(built) == len(names) else 1


if __name__ == "__main__":
    sys.exit(main())

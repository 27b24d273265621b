"""Variants of the 2-bit codec kernels (rows 14 and 15), checked and timed
on the card.

Each variant is ``mxnet_tpu_torch/csrc/compression.cu`` with named edits,
built with the port's nvcc flags into ``mxnet_tpu_torch/_build/probe/
codec/``. A variant is checked against the plain versions with
``chip_smoke.py``'s grouped check (the 54 compressed ResNet-50 sizes, the
edge sizes and a misaligned segment in one call; bf16 and f32; words,
residuals and decoded values bit for bit, the same bits on a second
launch). Each variant then times one train_kv step's codec work, the 54
compressed gradients in bf16 through one grouped quantize and one grouped
dequantize (the kernels' device time from the profiler, and the calls'
device time from CUDA events over 20 calls, the better of two), in a
process of its own, in turns (the list, then the list reversed).

    python3 chip_codec_probe.py [variant ...]      (default: all)
    python3 chip_codec_probe.py --sources DIR      (write the sources)

Variants:
  as_is       the source as it is (4 warps a block, 3 blocks an SM;
              quantize: a 2-stage ring of bulk copies per warp;
              dequantize: the chunk expanded in shared memory, one bulk
              store);
  b2s3        a 3-stage quantize ring at 2 blocks an SM (the same 192 KB
              in flight per SM, fewer warps; dequantize at 2 blocks too);
  vec8        quantize with no ring: each lane loads its 8 units of the
              chunk's gradient and residual as 16-byte __ldg loads, all 16
              in flight before the compute, at 8 blocks an SM (both
              kernels: the wrapper's BLOCKS_PER_SM, set in the worker);
  dq_direct   dequantize with no staging: each lane writes its 16-byte
              units straight to device memory (coalesced);
plans (the source as it is, called differently in the worker):
  per_tensor  one launch per tensor (54 of each kernel), as the store made
              them before it grouped its pushes.

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
SOURCE = "compression.cu"
ROWS = ("quantize", "dequantize")


def _sub(text, old, new):
    if text.count(old) != 1:
        raise ValueError("probe edit does not apply: %r" % old[:60])
    return text.replace(old, new)


def _vec(text):
    text = _sub(text, "constexpr int Q_SMEM = WARPS * Q_STAGES * Q_STAGE;",
                "constexpr int Q_SMEM = 0;")
    text = _sub(text, "  if (bulk && fw > 0) {\n    const unsigned bytes",
                "  if (false) {\n    const unsigned bytes")
    return _sub(text, """      const uint4* gs = reinterpret_cast<const uint4*>(stage);
      const uint4* rs = reinterpret_cast<const uint4*>(stage + SLAB);
      uint4* out = reinterpret_cast<uint4*>(static_cast<T*>(g.new_res) +
                                            w0 * GROUP);
      const int units = static_cast<int>(fw) * UPW;
      for (int base = 0; base < units; base += 32) {
        const int u = base + lane;
        uint32_t bits = 0u;
        if (u < units) {
          const uint4 gv = gs[u];
          uint4 rv = rs[u];""", """      const uint4* gs = reinterpret_cast<const uint4*>(
          static_cast<const T*>(g.grad) + w0 * GROUP);
      const uint4* rs = reinterpret_cast<const uint4*>(
          static_cast<const T*>(g.res) + w0 * GROUP);
      uint4* out = reinterpret_cast<uint4*>(static_cast<T*>(g.new_res) +
                                            w0 * GROUP);
      const int units = static_cast<int>(fw) * UPW;
      constexpr int PASSES = SLAB / 16 / 32;
      uint4 gl[PASSES], rl[PASSES];
#pragma unroll
      for (int p = 0; p < PASSES; ++p)
        if (32 * p + lane < units) {
          gl[p] = __ldg(gs + 32 * p + lane);
          rl[p] = __ldg(rs + 32 * p + lane);
        }
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const int base = 32 * p;
        if (base >= units) break;
        const int u = base + lane;
        uint32_t bits = 0u;
        if (u < units) {
          const uint4 gv = gl[p];
          uint4 rv = rl[p];""")


def _stages3(text):
    return _sub(text, "constexpr int Q_STAGES = 2;",
                "constexpr int Q_STAGES = 3;")


def _dq_direct(text):
    text = _sub(text, """          reinterpret_cast<float4*>(stage)[32 * i + lane] =""",
                """          reinterpret_cast<float4*>(g.out + w0 * GROUP)[32 * i + lane] =""")
    return _sub(text, """      asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        bulk_store(g.out + w0 * GROUP, stage,
                   static_cast<unsigned>(nw) * GROUP * 4u);
        tma_store_commit();
      }""", "")


VARIANTS = {"as_is": lambda text: text, "b2s3": _stages3, "vec8": _vec,
            "dq_direct": _dq_direct, "per_tensor": lambda text: text}
# The wrapper's constants that a variant sets (kernels/compression.py).
CONSTANTS = {"b2s3": {"BLOCKS_PER_SM": 2}, "vec8": {"BLOCKS_PER_SM": 8}}


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
    those that built, printing each codec kernel's ptxas report."""
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
                  if "Compiling entry function" in ln and "codec" in ln]
        emit({"variant": name, "built": proc.returncode == 0,
              "ptxas_codec": report,
              "errors": [ln for ln in lines if " error" in ln][:5]})
        if proc.returncode == 0:
            libs[name] = lib
    return libs


def _kernel_ms(torch, fn, names):
    """Device ms per call of fn() in the kernels whose names contain each
    of ``names`` (torch.profiler over 10 calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    out = {n: 0.0 for n in names}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        for n in names:
            if n in e.key:
                out[n] += t / 1e3 / 10
    return out


def worker(name, lib, check):
    """Checks (once per variant) and times one variant."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import compression as C
    _build._LIBS["compression"] = ctypes.CDLL(lib)
    for key, value in CONSTANTS.get(name, {}).items():
        setattr(C, key, value)
    state = {}
    sizes = cs._kv_sizes(mx, state)
    out = {"variant": name}
    if check:
        group = sizes + list(cs.CODEC_EDGE_N) + [(cs.CODEC_EDGE_N[-1],
                                                 "misaligned")]
        bad = []
        for dtype in (torch.bfloat16, torch.float32):
            for thr in cs.CODEC_THRESHOLDS:
                fails, _, counts = cs._codec_group_check(
                    torch, C, group, dtype, thr, seed=1700)
                bad += [[str(dtype), thr, f] for f in fails]
                if counts != ((1, len(group)), (1, len(group))):
                    bad.append([str(dtype), thr, "counts", counts])
        out["checks_ok"] = not bad
        out["failures"] = bad[:5]
    thr = cs.KV_COMPRESSION["threshold"]
    gen = torch.Generator(device="cuda").manual_seed(1500)
    gs = [(torch.randn(n, generator=gen, device="cuda") * 0.4)
          .to(torch.bfloat16) for n in sizes]
    rs = [(torch.randn(n, generator=gen, device="cuda") * 0.1)
          .to(torch.bfloat16) for n in sizes]
    words = C.quantize_2bit_group(gs, rs, thr)[0]
    if name == "per_tensor":
        calls = {"quantize": lambda: [C.quantize_2bit(g, r, thr)
                                      for g, r in zip(gs, rs)],
                 "dequantize": lambda: [C.dequantize_2bit(w, n, thr)
                                        for w, n in zip(words, sizes)]}
    else:
        calls = {"quantize": lambda: C.quantize_2bit_group(gs, rs, thr),
                 "dequantize": lambda: C.dequantize_2bit_group(words, sizes,
                                                               thr)}
    out["kernel_ms"] = {row: _kernel_ms(torch, fn, ["codec_%s" % row])[
        "codec_%s" % row] for row, fn in calls.items()}
    out["call_ms"] = {row: min(cs.device_ms(torch, fn, iters=20)
                               for _ in range(2))
                      for row, fn in calls.items()}
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
        print("chip_codec_probe: no CUDA device; this probe needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build", "probe",
                           "codec")
    libs = build(write_sources(names, out_dir))
    built = [n for n in names if n in libs]
    rows, ok = {n: [] for n in built}, {}
    for turn in (built, built[::-1]):
        for name in turn:
            check = name not in ok
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--worker", name, libs[name],
                                "1" if check else "0"],
                               capture_output=True, text=True, timeout=900)
            lines = [ln for ln in r.stdout.splitlines()
                     if ln.startswith("{")]
            if r.returncode != 0 or not lines:
                emit({"variant": name, "failed": r.returncode,
                      "stderr": r.stderr[-800:]})
                rows[name].append(None)
                continue
            res = json.loads(lines[-1])
            print(lines[-1], flush=True)
            rows[name].append([res["kernel_ms"][k] for k in ROWS])
            if check:
                ok[name] = res["checks_ok"]
    emit({"smi": smi, "quantize_dequantize_kernel_ms_per_step_in_turns":
          rows, "checks_ok": ok})
    return 0 if all(ok.values()) and len(built) == len(names) else 1


if __name__ == "__main__":
    sys.exit(main())

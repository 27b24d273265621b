"""Variants of the int8 matmul's wgmma route, checked and timed on the card.

Each variant is ``mxnet_tpu_torch/csrc/quantized_matmul.cu`` with named
edits of the wgmma kernel, built with the port's nvcc flags into
``mxnet_tpu_torch/_build/probe/qmm/``. A variant is checked against the
plain version at int8 ResNet-50 v1's 21 distinct product shapes at batch
32 and at ``chip_smoke.py``'s wgmma edge shapes, both forms, bit for bit
and with the same bits on a second launch. Each variant then times both
forms at the 21 shapes (CUDA events over 20 launches, twice) in a process
of its own, in turns (the list, then the list reversed), and prints the
totals per op-family pass (row 12: one int32 product at each shape) and
per b32 forward (row 13: the scaled products, by their launch counts).

    python3 chip_qmm_probe.py [variant ...]      (default: all)
    python3 chip_qmm_probe.py --sources DIR      (write the sources)

Variants:
  as_is          the source as it is (tiles numbered N fastest, a 4-stage
                 ring, one staging tile per consumer warpgroup);
  m_fastest      tiles numbered M fastest: the blocks in flight share w's
                 columns in L2 rather than x's rows;
  staging2       two staging tiles per consumer warpgroup, used in turn,
                 so that a tile's epilogue does not wait for the store
                 before it to leave shared memory (and a 3-stage ring, to
                 fit);
  staging2_bn64  two staging tiles only where tiles are 64 columns wide
                 (N = 64), with the 4-stage ring;
  prefetch       the tensor maps prefetched at the kernel's start;
plans (the source as it is, qmm_plan's constants set in the worker):
  no_split       K never split (_MAX_SPLIT 1);
  split_more     a split modelled at 0.25 us (_PART_US), so that more
                 products split.

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
SOURCE = "quantized_matmul.cu"
# The wgmma route's region of the source: an edit changes only it.
START = "// The wgmma route\n"
END = "// The byte route\n"

# int8 ResNet-50 v1's distinct (M, K, N) products at batch 32 and their
# launches per forward (chip_smoke.py reads the same off the network).
INT8_B32_SHAPES = [
    ((32, 2048, 1000), 1), ((1568, 512, 2048), 3), ((1568, 1024, 512), 1),
    ((1568, 1024, 2048), 1), ((1568, 2048, 512), 2), ((1568, 4608, 512), 3),
    ((6272, 256, 1024), 6), ((6272, 512, 256), 1), ((6272, 512, 1024), 1),
    ((6272, 1024, 256), 5), ((6272, 2304, 256), 6), ((25088, 128, 512), 4),
    ((25088, 256, 128), 1), ((25088, 256, 512), 1), ((25088, 512, 128), 3),
    ((25088, 1152, 128), 4), ((100352, 64, 64), 1), ((100352, 64, 256), 4),
    ((100352, 256, 64), 2), ((100352, 576, 64), 3), ((401408, 160, 64), 1)]


def _sub(text, old, new):
    a = text.index(START)
    b = text.index(END, a)
    body = text[a:b]
    if body.count(old) != 1:
        raise ValueError("probe edit does not apply: %r" % old[:60])
    return text[:a] + body.replace(old, new) + text[b:]


def _m_fastest(text):
    return _sub(text, """  const int tm = it.tile / a.tiles_n;
  it.m0 = tm * QBM;
  it.n0 = (it.tile - tm * a.tiles_n) * BN;""", """  const int tiles_m = a.tiles / a.tiles_n;
  const int tn = it.tile / tiles_m;
  it.m0 = (it.tile - tn * tiles_m) * QBM;
  it.n0 = tn * BN;""")


def _staging2(text):
    text = _sub(text, "constexpr int QSTAGES = 4;",
                "constexpr int QSTAGES = 3;")
    text = _sub(text, "SMEM = QSTAGES * STAGE + 2 * STAGING + 1024;",
                "SMEM = QSTAGES * STAGE + 4 * STAGING + 1024;")
    text = _sub(text, """  unsigned char* staging = ring + QSTAGES * C::STAGE + wg * C::STAGING;
""", """  unsigned char* const pair = ring + QSTAGES * C::STAGE + wg * 2 * C::STAGING;
  int stored = 0;
""")
    return _sub(text, """      if (tid == 0) tma_store_wait_read();
      q_bar(wg);""", """      unsigned char* staging = pair + (stored++ & 1) * C::STAGING;
      if (tid == 0)
        asm volatile("cp.async.bulk.wait_group.read 1;\\n" ::: "memory");
      q_bar(wg);""")


def _staging2_bn64(text):
    text = _sub(text, "SMEM = QSTAGES * STAGE + 2 * STAGING + 1024;",
                "SMEM = QSTAGES * STAGE + (BN == 64 ? 4 : 2) * STAGING + 1024;")
    text = _sub(text, """  unsigned char* staging = ring + QSTAGES * C::STAGE + wg * C::STAGING;
""", """  unsigned char* const pair =
      ring + QSTAGES * C::STAGE + wg * (BN == 64 ? 2 : 1) * C::STAGING;
  int stored = 0;
""")
    return _sub(text, """      if (tid == 0) tma_store_wait_read();
      q_bar(wg);""", """      unsigned char* staging =
          pair + (BN == 64 ? stored++ & 1 : 0) * C::STAGING;
      if (tid == 0) {
        if (BN == 64)
          asm volatile("cp.async.bulk.wait_group.read 1;\\n" ::: "memory");
        else
          tma_store_wait_read();
      }
      q_bar(wg);""")


def _prefetch(text):
    return _sub(text, """  const int wg = threadIdx.x >> 7;
  if (wg == 2) {""", """  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0 || threadIdx.x == 256) {
    const CUtensorMap* maps[2] = {threadIdx.x ? &tmx : &tmo, &tmw};
    for (int i = 0; i < 1 + (threadIdx.x != 0); ++i)
      asm volatile("prefetch.tensormap [%0];\\n" ::"l"(
                       reinterpret_cast<uint64_t>(maps[i]))
                   : "memory");
  }
  if (wg == 2) {""")


VARIANTS = {"as_is": lambda text: text, "m_fastest": _m_fastest,
            "staging2": _staging2, "staging2_bn64": _staging2_bn64,
            "prefetch": _prefetch, "no_split": lambda text: text,
            "split_more": lambda text: text}
# qmm_plan's constants that a variant sets (kernels/quantized_matmul.py).
PLANS = {"no_split": {"_MAX_SPLIT": 1}, "split_more": {"_PART_US": 0.25}}


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
    those that built, printing each wgmma kernel's ptxas report."""
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
                  if "Compiling entry function" in ln and "wgmma" in ln]
        emit({"variant": name, "built": proc.returncode == 0,
              "ptxas_wgmma": report,
              "errors": [ln for ln in lines if " error" in ln][:5]})
        if proc.returncode == 0:
            libs[name] = lib
    return libs


def worker(name, lib, check):
    """Checks (once per variant) and times one variant."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import quantized_matmul as QM
    _build._LIBS["quantized_matmul"] = ctypes.CDLL(lib)
    for key, value in PLANS.get(name, {}).items():
        setattr(QM, key, value)
    QM.qmm_plan.cache_clear()
    out = {"variant": name}
    if check:
        bad = []
        shapes = [s for s, _ in INT8_B32_SHAPES] + cs.QMM_WGMMA_EDGE
        for i, (M, K, N) in enumerate(shapes):
            x, w, s = cs.qmm_case(torch, M, K, N, 900 + i, -128)
            for form, r in cs.qmm_check(torch, x, w, s).items():
                if not (r[0] and r[1] and r[3] == "wgmma"):
                    bad.append([M, K, N, form])
        out["checks_ok"] = not bad
        out["failures"] = bad[:5]
    per, splits = {}, {}
    for i, ((M, K, N), count) in enumerate(INT8_B32_SHAPES):
        x, w, s = cs.qmm_case(torch, M, K, N, 800 + i)
        splits["%dx%dx%d" % (M, K, N)] = QM.qmm_plan(
            M, K, N, QM._sm_count(x.device)).nsplit
        per["%dx%dx%d" % (M, K, N)] = [
            min(cs.device_ms(torch, lambda: QM.quantized_matmul(x, w, sc),
                             iters=20) for _ in range(2))
            for sc in (None, s)]
    out["ms_per_shape_mm_mm_scaled"] = per
    out["nsplit"] = {k: v for k, v in splits.items() if v > 1}
    out["row12_ms"] = sum(v[0] for v in per.values())
    out["row13_ms"] = sum(count * per["%dx%dx%d" % shape][1]
                          for shape, count in INT8_B32_SHAPES)
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
        print("chip_qmm_probe: no CUDA device; this probe needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build", "probe", "qmm")
    libs = build(write_sources(names, out_dir))
    built = [n for n in names if n in libs]
    rows, ok = {n: [] for n in built}, {}
    for turn in (built, built[::-1]):
        for name in turn:
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
                continue
            res = json.loads(lines[-1])
            print(lines[-1], flush=True)
            rows[name].append([res["row12_ms"], res["row13_ms"]])
            if check:
                ok[name] = res["checks_ok"]
    emit({"smi": smi, "row12_row13_ms_in_turns": rows, "checks_ok": ok})
    return 0 if all(ok.values()) and len(built) == len(names) else 1


if __name__ == "__main__":
    sys.exit(main())

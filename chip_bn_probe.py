"""Variants of the two BatchNorm folds (rows 4 and 6), checked and timed on
the card.

Each variant is ``mxnet_tpu_torch/csrc/batchnorm_fused.cu`` with named
edits, built with the port's nvcc flags into
``mxnet_tpu_torch/_build/probe/bn/``. A variant is checked against the
plain versions at ResNet-50's nine training shapes at batch 128 (bf16,
relu off and on) and at edge shapes (f32, both fold routes, plans for a
card of 5 SMs): the stats bit for bit, the backward reduce within
``chip_smoke.BN_BWD_RTOL``, both with the same bits on a second launch.
Each variant then times both folds at the nine shapes (CUDA events over 20
calls, the better of two) in a process of its own, in turns (the list,
then the list reversed), and prints the totals per training step. The
first turn of each variant also splits each call's device time into the
fold and the finalize launch (``torch.profiler``; the rest of the call's
time is the launches' gaps).

    python3 chip_bn_probe.py [variant ...]      (default: all)
    python3 chip_bn_probe.py --sources DIR      (write the sources)

Variants:
  as_is     the source as it is (8 warps a block, a 3-stage ring of 8 KB
            stages per warp, the backward's slabs 64 bytes wide);
  stages2   a 2-stage ring per warp;
  warps4    4 warps a block, each with a 6-stage ring;
  bwd128    the backward's slabs 128 bytes wide (16 KB stages: x and dy),
            4 warps a block, 3 stages;
  pdl       the finalize launched as a programmatic dependent of the fold
            (the fold lets it launch at its start; it waits for the fold's
            results), so that its launch overlaps the fold's tail;
plans (the source as it is, fold_plan changed in the worker):
  items2x   twice the items (partial rows G' doubled, K halved), for a
            finer balance across the SMs at the cost of more partial rows.

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
SOURCE = "batchnorm_fused.cu"
FOLDS = ("stats", "bwd_reduce")


def _sub(text, old, new):
    if text.count(old) != 1:
        raise ValueError("probe edit does not apply: %r" % old[:60])
    return text.replace(old, new)


def _stages2(text):
    return _sub(text, "constexpr int FOLD_STAGES = 3;",
                "constexpr int FOLD_STAGES = 2;")


def _warps4(text):
    text = _sub(text, "constexpr int FOLD_WARPS = 8;",
                "constexpr int FOLD_WARPS = 4;")
    return _sub(text, "constexpr int FOLD_STAGES = 3;",
                "constexpr int FOLD_STAGES = 6;")


def _bwd128(text):
    text = _sub(text, "constexpr int FOLD_WARPS = 8;",
                "constexpr int FOLD_WARPS = 4;")
    text = _sub(text, "constexpr int FOLD_STAGE_BYTES = 8192;",
                "constexpr int FOLD_STAGE_BYTES = 16384;")
    return _sub(text, """  static constexpr int TENSORS = 2;
  static constexpr int BS = 64;""", """  static constexpr int TENSORS = 2;
  static constexpr int BS = 128;""")


def _pdl(text):
    text = _sub(text, """  const int c = blockIdx.x * FIN_CH + threadIdx.x;
  const int t = threadIdx.y;""", """  asm volatile("griddepcontrol.wait;\\n" ::: "memory");
  const int c = blockIdx.x * FIN_CH + threadIdx.x;
  const int t = threadIdx.y;""")
    text = _sub(text, """  __syncthreads();

  const bool active = h < (1 << a.logH);""", """  __syncthreads();
  asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");

  const bool active = h < (1 << a.logH);""")
    return _sub(text, """  dim3 block(FIN_CH, 1 << logT);
  bn_finalize_kernel<<<(C + FIN_CH - 1) / FIN_CH, block, 0, stream>>>(
      pa, pb, logG - logT, C, Rf, mode, oa, ob);
  return static_cast<int>(cudaGetLastError());""", """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((C + FIN_CH - 1) / FIN_CH);
  cfg.blockDim = dim3(FIN_CH, 1 << logT);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, bn_finalize_kernel, pa,
                                             pb, logG - logT, C, Rf, mode,
                                             oa, ob));""")


VARIANTS = {"as_is": lambda text: text, "stages2": _stages2,
            "warps4": _warps4, "bwd128": _bwd128, "pdl": _pdl,
            "items2x": lambda text: text}
# fold_plan's SM count is multiplied by this in a plan variant's worker
# (the grid stays one block per SM).
PLANS = {"items2x": 2}
# The wrapper's constants that a variant sets
# (kernels/batchnorm_fused.py), to match its source.
CONSTANTS = {"warps4": {"FOLD_WARPS": 4},
             "bwd128": {"FOLD_WARPS": 4,
                        "SLAB_BYTES": {"stats": 128, "bwd_reduce": 128}}}


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
    those that built, printing each fold kernel's ptxas report."""
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
                  if "Compiling entry function" in ln and "fold" in ln]
        emit({"variant": name, "built": proc.returncode == 0,
              "ptxas_fold": report,
              "errors": [ln for ln in lines if " error" in ln][:5]})
        if proc.returncode == 0:
            libs[name] = lib
    return libs


def _checks(torch, cs, BNF):
    """Failures of the folds at the training shapes and edge shapes."""
    bad = []
    cases = [(int(cs.np.prod(shape[:3])), shape[3], "bfloat16", act, None)
             for shape, _ in cs.BN_SHAPES for act in (None, "relu")]
    cases += [(4097, 72, "float32", "relu", None), (65, 129, "bfloat16",
                                                    None, None)]
    cases += [c for c in cs.BN_SEVERAL_ITEMS if c[4] is not None]
    sm_count = BNF._sm_count
    try:
        for i, (R, C, dname, act, n_sm) in enumerate(cases):
            BNF._sm_count = sm_count if n_sm is None else (lambda dev: n_sm)
            x2, g, b, dy = cs.bn_case(torch, R, C, getattr(torch, dname),
                                      seed=900 + i)
            res = cs.bn_check(torch, x2, g, b, dy, act)
            bad += [[R, C, dname, act, n_sm, k] for k in FOLDS
                    if not res[k][0]]
            del x2, g, b, dy
    finally:
        BNF._sm_count = sm_count
    return bad


def _split(torch, fn):
    """Device ms per call of each kernel fn launches, by name
    (torch.profiler over 10 calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        name = "fold" if "bn_fold_kernel" in e.key else \
            "finalize" if "bn_finalize_kernel" in e.key else None
        if name:
            out[name] = out.get(name, 0.0) + t / 1e3 / 10
    return out


def worker(name, lib, check):
    """Checks (once per variant) and times one variant."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
    _build._LIBS["batchnorm_fused"] = ctypes.CDLL(lib)
    for key, value in CONSTANTS.get(name, {}).items():
        setattr(BNF, key, value)
    if name in PLANS:
        plan, times = BNF.fold_plan, PLANS[name]
        BNF.fold_plan = lambda R, C, n_sm, slab: plan(
            R, C, times * n_sm, slab)._replace(grid=min(
                plan(R, C, times * n_sm, slab).items, n_sm))
    out = {"variant": name}
    if check:
        bad = _checks(torch, cs, BNF)
        out["checks_ok"] = not bad
        out["failures"] = bad[:5]
    per, split, totals = {}, {}, {k: 0.0 for k in FOLDS}
    for i, (shape, count) in enumerate(cs.BN_SHAPES):
        N, H, W, C = shape
        x2, g, b, dy = cs.bn_case(torch, N * H * W, C, torch.bfloat16,
                                  seed=500 + i)
        mean, var = BNF.stats_reference(x2)
        calls = {"stats": lambda: BNF.stats(x2),
                 "bwd_reduce": lambda: BNF.bwd_reduce(
                     x2, dy, g, b, mean, var, cs.BN_EPS)}
        key = "%dx%dx%dx%d" % shape
        per[key] = {k: min(cs.device_ms(torch, fn, iters=20)
                           for _ in range(2)) for k, fn in calls.items()}
        if check:
            split[key] = {k: _split(torch, fn) for k, fn in calls.items()}
        for k in FOLDS:
            totals[k] += count * per[key][k]
        del x2, g, b, dy
    out["ms_per_launch"] = per
    if check:
        out["device_ms_split"] = split
    out["per_step_ms"] = totals
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
        print("chip_bn_probe: no CUDA device; this probe needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build", "probe", "bn")
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
            rows[name].append([res["per_step_ms"][k] for k in FOLDS])
            if check:
                ok[name] = res["checks_ok"]
    emit({"smi": smi, "stats_bwd_reduce_ms_per_step_in_turns": rows,
          "checks_ok": ok})
    return 0 if all(ok.values()) and len(built) == len(names) else 1


if __name__ == "__main__":
    sys.exit(main())

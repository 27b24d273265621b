"""Variants of the bf16 flash-attention dK/dV kernel, timed on the card.

Each variant is ``mxnet_tpu_torch/csrc/flash_attention.cu`` with one named
edit of the dK/dV kernel, built with the port's nvcc flags into
``mxnet_tpu_torch/_build/probe/``. A variant is checked against the plain
version at the transformer LM's attention (batch cut to 1, as the
[B, S, H, D] views the LM passes) and at ``chip_smoke.py``'s edge shapes
(every output within FLASH_RTOL, dk and dv the same bits on a second
launch and over ten launches at the LM's full shape); an ablation, which
leaves out work and so gives wrong results, is only timed. Each variant
then runs the dK/dV kernel alone at the LM's attention (B 12, H 32,
S 2048, D 128, causal, bf16) in a process of its own, in turns (the list,
then the list reversed), and prints its ms per launch (CUDA events over 20
launches, twice a turn).

    python3 chip_flash_probe.py [variant ...]     (default: all)
    python3 chip_flash_probe.py --sources DIR     (write the sources only)

Variants:
  as_is           the source as it is;
  no_turns        the two warpgroups issue without taking turns;
  early_dv        no turns, and dV += P^T dO issued before dS^T is formed;
  stages3         a 3-stage Q/dO ring;
  step_b          a 3-stage ring, and each turn issues the next q tile's
                  S^T and dP^T with this tile's dV and dK;
ablations (timed only):
  no_exp          P^T = S^T * scale - lse, with no exp;
  no_elementwise  no scale, mask, exp or dS: the scores packed as they are;
  no_scores       no S^T or dP^T products: constant scores.

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
KERNEL = "flash_dkv_bf16_kernel(const __grid_constant__"
END = "// f32 kernels (CUDA cores"


def _region(text):
    """(start, end) of the dK/dV kernel's body in the source."""
    a = text.index(KERNEL)
    return a, text.index(END, a)


def _sub(text, old, new, kernel_only=True):
    a, b = _region(text) if kernel_only else (0, len(text))
    body = text[a:b]
    if body.count(old) != 1:
        raise ValueError("probe edit does not apply: %r" % old[:60])
    return text[:a] + body.replace(old, new) + text[b:]


def _no_turns(text):
    a, b = _region(text)
    body = text[a:b]
    if "turn_wait(wg);" not in body:
        raise ValueError("probe edit does not apply: no turns")
    body = body.replace("turn_wait(wg);", "(void)0;")
    return text[:a] + body.replace("turn_pass(wg);", "(void)0;") + text[b:]


def _stages3(text):
    return _sub(text, "constexpr int DKV_STAGES = 2;",
                "constexpr int DKV_STAGES = 3;", kernel_only=False)


ACC1 = """// acc += A (registers, four k-steps) * B (a q tile, N-major), one group.
template <int D>
__device__ __forceinline__ void dkv_acc1(float (&acc)[D / 8][4],
                                         const uint32_t (&f)[4][4],
                                         const unsigned char* b) {
  asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(acc, f[kk], sw128_desc_at(b + kk * 2048, QBOX, 1024));
  asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
}

"""

ELEMENTWISE = """#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nn][e] = __fmul_rn(s[nn][e], a.scale);
    if (q0 + QT > a.Sq || (a.causal && q0 < k0 + wg * 64 + 64)) {
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + nn * 8 + 2 * t + (e & 1);
          if (q >= a.Sq || (a.causal && key0 + (e >> 1) * 8 > q))
            s[nn][e] = -INFINITY;
        }
    }
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      const float2 l = *reinterpret_cast<const float2*>(lrow + nn * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nn][e] = expf(__fsub_rn(s[nn][e], (e & 1) ? l.y : l.x));
    }
"""

DSCORE = """#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      const float2 d = *reinterpret_cast<const float2*>(drow + nn * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nn][e] = __fmul_rn(
            __fmul_rn(s[nn][e], __fsub_rn(dp[nn][e], (e & 1) ? d.y : d.x)),
            a.scale);
    }
"""

SCORES = """    dkv_scores<D>(s, kw, qt);
    dkv_scores<D>(dp, vw, dot);
"""


def _early_dv(text):
    text = _no_turns(text)
    k = text.index("template <int D>\n__global__ void __launch_bounds__"
                   "(FWD_THREADS, 1)\n" + KERNEL)
    text = text[:k] + ACC1 + text[k:]
    text = _sub(text, """    // dS^T = P^T (dP^T - delta) * scale
    asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");""",
                """    pack_frag(pa, s);
    reg_fence_all(pa);
    dkv_acc1<D>(dv, pa, dot);
    asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");""")
    return _sub(text, """    pack_frag(pa, s);
    pack_frag(da, dp);
    reg_fence_all(pa);
    reg_fence_all(da);
    (void)0;
    dkv_acc<D>(dv, dk, pa, da, qt, dot);""", """    pack_frag(da, dp);
    reg_fence_all(da);
    dkv_acc1<D>(dk, da, qt);""")


STEP_B = """  mbar_wait(&kvfull, 0);
  if (wg == 1) turn_pass(wg);
  int i = 0;
  if (a.causal && wg == 1) {
    turn_wait(wg);
    turn_pass(wg);
    if (n == 1) turn_wait(wg);
    mbar_wait(&full[0], 0);
    release(0);
    i = 1;
  }
  auto tile = [&](int j) { return ring + 2 * (j % DKV_STAGES) * SB; };
  auto p_pass = [&](int j) {
    const int q0 = (t0 + j) * QT;
    const float* lrow = rowv[j % DKV_STAGES][0];
ELEMENTWISE  };
  auto ds_pass = [&](int j) {
    const float* drow = rowv[j % DKV_STAGES][1];
DSCORE  };
  if (i < n) {
    turn_wait(wg);
    mbar_wait(&full[i % DKV_STAGES], (i / DKV_STAGES) & 1);
    dkv_scores<D>(s, kw, tile(i));
    dkv_scores<D>(dp, vw, tile(i) + SB);
    turn_pass(wg);
    asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");
    reg_fence_all(s);
    p_pass(i);
    asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
    reg_fence_all(dp);
    ds_pass(i);
    pack_frag(pa, s);
    pack_frag(da, dp);
    reg_fence_all(pa);
    reg_fence_all(da);
    for (; i + 1 < n; ++i) {
      turn_wait(wg);
      mbar_wait(&full[(i + 1) % DKV_STAGES], ((i + 1) / DKV_STAGES) & 1);
      dkv_scores<D>(s, kw, tile(i + 1));
      dkv_scores<D>(dp, vw, tile(i + 1) + SB);
      dkv_acc<D>(dv, dk, pa, da, tile(i), tile(i) + SB);
      turn_pass(wg);
      asm volatile("wgmma.wait_group.sync.aligned 2;\\n" ::: "memory");
      reg_fence_all(s);
      p_pass(i + 1);
      asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");
      reg_fence_all(dp);
      ds_pass(i + 1);
      asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
      reg_fence_all(dv);
      reg_fence_all(dk);
      reg_fence_all(pa);
      reg_fence_all(da);
      release(i);
      pack_frag(pa, s);
      pack_frag(da, dp);
      reg_fence_all(pa);
      reg_fence_all(da);
    }
    turn_wait(wg);
    dkv_acc<D>(dv, dk, pa, da, tile(i), tile(i) + SB);
    pass(true);
    asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
    reg_fence_all(dv);
    reg_fence_all(dk);
    release(i);
  }

""".replace("ELEMENTWISE", ELEMENTWISE).replace("DSCORE", DSCORE)


def _step_b(text):
    text = _stages3(text)
    a, b = _region(text)
    body = text[a:b]
    i = body.index("  mbar_wait(&kvfull, 0);\n")
    j = body.index("  // dK and dV in bf16 into this warpgroup")
    return text[:a] + body[:i] + STEP_B + body[j:] + text[b:]


def _no_exp(text):
    return _sub(text,
                "s[nn][e] = expf(__fsub_rn(s[nn][e], (e & 1) ? l.y : l.x));",
                "s[nn][e] = __fsub_rn(s[nn][e], (e & 1) ? l.y : l.x);")


def _no_elementwise(text):
    return _sub(_sub(text, ELEMENTWISE, ""), DSCORE, "")


def _no_scores(text):
    return _sub(text, SCORES, """#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        asm volatile("mov.b32 %0, 0f3C000000;" : "=f"(s[nn][e]));
        asm volatile("mov.b32 %0, 0f3C000000;" : "=f"(dp[nn][e]));
      }
""")


VARIANTS = {"as_is": lambda t: t, "no_turns": _no_turns,
            "early_dv": _early_dv, "stages3": _stages3, "step_b": _step_b}
ABLATIONS = {"no_exp": _no_exp, "no_elementwise": _no_elementwise,
             "no_scores": _no_scores}


def write_sources(names, out_dir):
    """Each variant's flash_attention.cu (and the shared header) under
    out_dir/<name>/; returns {name: source path}."""
    with open(os.path.join(CSRC, "flash_attention.cu")) as f:
        text = f.read()
    with open(os.path.join(CSRC, "sm90.cuh")) as f:
        header = f.read()
    paths = {}
    for name in names:
        edit = VARIANTS.get(name) or ABLATIONS[name]
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "flash_attention.cu"), "w") as f:
            f.write(edit(text))
        with open(os.path.join(d, "sm90.cuh"), "w") as f:
            f.write(header)
        paths[name] = os.path.join(d, "flash_attention.cu")
    return paths


def emit(obj):
    print(json.dumps(obj), flush=True)


def build(paths):
    """One nvcc per variant, all at once; returns {name: library path} of
    those that built, printing each dK/dV kernel's ptxas report."""
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
        report = {}
        lines = out.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and "flash_dkv_bf16" in ln:
                d = "D128" if "Li128" in ln else "D64"
                report[d] = " | ".join(x.strip() for x in lines[i + 2:i + 4])
        emit({"variant": name, "built": proc.returncode == 0,
              "ptxas_dkv": report,
              "errors": [ln for ln in lines if " error" in ln][:5]})
        if proc.returncode == 0:
            libs[name] = lib
    return libs


def worker(name, lib, check):
    """Checks (unless an ablation) and times one variant."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import flash_attention as FA
    _build._LIBS["flash_attention"] = ctypes.CDLL(lib)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"variant": name}
    if check:
        cases = [(cs.FLASH_MAIN, "bshd")] + [(c, "bhsd")
                                             for c in cs.FLASH_EDGE]
        bad = []
        for i, (case, layout) in enumerate(cases):
            res, outs, ins = cs.flash_check(torch, case, torch.bfloat16,
                                            1100 + i, layout)
            q, k, v, do, ro, rlse = ins
            again = FA._flash_backward(q, k, v, ro, rlse, do, case[5],
                                       case[4] ** -0.5)
            torch.cuda.synchronize()
            if not (torch.equal(outs[3], again[1])
                    and torch.equal(outs[4], again[2])):
                bad.append([list(case), "second launch bits"])
            bad += [[list(case), n] for n in res if not res[n]["ok"]]
        out["checks_ok"] = not bad
        out["failures"] = bad[:5]
    B, H, S, D = cs.LM_BATCH, cs.LM_CFG["n_heads"], cs.LM_SEQ, 128
    q, k, v, do = cs.flash_case(torch, (B, H, S, S, D, True),
                                torch.bfloat16, seed=1200)
    o, lse = FA._flash_forward(q, k, v, True, D ** -0.5)
    delta = (do.float() * o.float()).sum(dim=-1).reshape(B * H, S)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    strides = FA._strides(q, k, v, do, dk, dv)
    stream = torch.cuda.current_stream().cuda_stream
    fn = FA._fn("flash_dkv")

    def launch():
        err = fn(0, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B * H, H, S, S, D, 1, D ** -0.5, strides,
                 stream)
        if err:
            raise RuntimeError("flash_dkv launch failed: cudaError %d" % err)
    if check:
        launch()
        first = (dk.clone(), dv.clone())
        same = True
        for _ in range(10):
            launch()
            torch.cuda.synchronize()
            same = same and torch.equal(dk, first[0]) \
                and torch.equal(dv, first[1])
        out["lm_shape_same_bits_10_launches"] = same
        out["checks_ok"] = out["checks_ok"] and same
    out["ms"] = [cs.device_ms(torch, launch, iters=20) for _ in range(2)]
    emit(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*",
                    default=list(VARIANTS) + list(ABLATIONS))
    ap.add_argument("--sources", help="write the variants' sources to this "
                    "directory and stop")
    ap.add_argument("--worker", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        name, lib, check = args.worker
        worker(name, lib, check == "1")
        return 0
    unknown = set(args.variants) - set(VARIANTS) - set(ABLATIONS)
    if unknown:
        ap.error("unknown variants %s" % sorted(unknown))
    if args.sources:
        write_sources(args.variants, args.sources)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_flash_probe: no CUDA device; this probe needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build", "probe")
    libs = build(write_sources(args.variants, out_dir))
    names = [n for n in args.variants if n in libs]
    ms, ok = {n: [] for n in names}, {}
    for turn in (names, names[::-1]):
        for name in turn:
            check = name in VARIANTS and name not in ok
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--worker", name, libs[name],
                                "1" if check else "0"],
                               capture_output=True, text=True, timeout=600)
            lines = [ln for ln in r.stdout.splitlines()
                     if ln.startswith("{")]
            if r.returncode != 0 or not lines:
                emit({"variant": name, "failed": r.returncode,
                      "stderr": r.stderr[-800:]})
                ms[name].append(None)
                continue
            res = json.loads(lines[-1])
            print(lines[-1], flush=True)
            ms[name] += res["ms"]
            if check:
                ok[name] = res["checks_ok"]
    emit({"smi": smi, "shape_bhsd": [12, 32, 2048, 2048, 128],
          "causal": True, "dkv_ms_per_launch_in_turns": ms,
          "checks_ok": ok})
    return 0 if all(ok.values()) and len(names) == len(args.variants) \
        else 1


if __name__ == "__main__":
    sys.exit(main())

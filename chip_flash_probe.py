"""Variants of the bf16 flash-attention backward kernels, timed on the card.

Each variant is ``mxnet_tpu_torch/csrc/flash_attention.cu`` with one named
edit of the dQ or the dK/dV kernel (``--kernel dq|dkv``, dkv by default),
built with the port's nvcc flags into ``mxnet_tpu_torch/_build/probe/``. A
variant is checked against the plain version at the transformer LM's
attention (batch cut to 1, as the [B, S, H, D] views the LM passes) and at
``chip_smoke.py``'s edge shapes (every output within FLASH_RTOL, the
kernel's outputs the same bits on a second launch and over ten launches at
the LM's full shape); an ablation, which leaves out work and so gives wrong
results, is only timed, as is a dropped form that is known to be wrong at
a shape. Each variant then runs its kernel alone at the
LM's attention (B 12, H 32, S 2048, D 128, causal, bf16) in a process of
its own, in turns (the list, then the list reversed), and prints its ms per
launch (CUDA events over 20 launches, twice a turn).

    python3 chip_flash_probe.py [--kernel dq|dkv] [variant ...]  (default: all)
    python3 chip_flash_probe.py --kernel dq --sources DIR  (write the sources)

dK/dV variants:
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

dQ variants:
  as_is           the source as it is (k tiles of 128 keys, S and dP by
                  m64n128k16 with Q and dO from shared memory);
  no_turns        the two warpgroups issue without taking turns;
  step_a          k tiles of 64 keys (m64n64k16 scores): warpgroup 0
                  skips a causal block's last tile;
timed only:
  step_b          step_a with each warp's rows of Q and dO loaded once
                  into registers as the A fragments of S and dP (right at
                  D = 128; wrong at D = 64, where ptxas gives the dO
                  fragments' registers to the packed dS though the PTX
                  keeps them apart);
  no_exp          P = S * scale - lse, with no exp;
  no_scores       no S or dP products: constant scores.

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
# Each kernel's region of the source: from its signature to the next
# section. An edit changes its kernel's region (and named constants).
KERNEL = "flash_dkv_bf16_kernel(const __grid_constant__"
END = "// bf16 dQ (TMA, wgmma)"
DQ_KERNEL = "flash_dq_bf16_kernel(const __grid_constant__"
DQ_END = "// f32 kernels (CUDA cores"
REGIONS = {"dkv": (KERNEL, END), "dq": (DQ_KERNEL, DQ_END)}


def _region(text, kernel="dkv"):
    """(start, end) of the kernel's body in the source."""
    start, end = REGIONS[kernel]
    a = text.index(start)
    return a, text.index(end, a)


def _sub(text, old, new, kernel_only=True, kernel="dkv"):
    a, b = _region(text, kernel) if kernel_only else (0, len(text))
    body = text[a:b]
    if body.count(old) != 1:
        raise ValueError("probe edit does not apply: %r" % old[:60])
    return text[:a] + body.replace(old, new) + text[b:]


def _no_turns(text, kernel="dkv"):
    a, b = _region(text, kernel)
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

# -- dQ -----------------------------------------------------------------------

RS_KK_TEXT = r"""// d = A (64 x 16, registers, the mma.m16n8k16 A fragment of each warp's 16
// rows) * B (16 x 64, shared memory, K-major: the transpose bit clear), d's
// old value ignored: the first k-step of a product.
__device__ __forceinline__ void wgmma_rs_kk_first(float (&d)[8][4],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "=f"(d[0][0]), "=f"(d[0][1]), "=f"(d[0][2]), "=f"(d[0][3]),
        "=f"(d[1][0]), "=f"(d[1][1]), "=f"(d[1][2]), "=f"(d[1][3]),
        "=f"(d[2][0]), "=f"(d[2][1]), "=f"(d[2][2]), "=f"(d[2][3]),
        "=f"(d[3][0]), "=f"(d[3][1]), "=f"(d[3][2]), "=f"(d[3][3]),
        "=f"(d[4][0]), "=f"(d[4][1]), "=f"(d[4][2]), "=f"(d[4][3]),
        "=f"(d[5][0]), "=f"(d[5][1]), "=f"(d[5][2]), "=f"(d[5][3]),
        "=f"(d[6][0]), "=f"(d[6][1]), "=f"(d[6][2]), "=f"(d[6][3]),
        "=f"(d[7][0]), "=f"(d[7][1]), "=f"(d[7][2]), "=f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

// d += A (64 x 16, registers) * B (16 x 64, shared memory, K-major).
__device__ __forceinline__ void wgmma_rs_kk(float (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

"""

# Step B's helpers: a warp's 16 rows of Q or dO as wgmma A fragments
# (ldmatrix on the 128-byte swizzle), and S = Q K^T (dP = dO V^T) with A
# from those registers and K (V) K-major in shared memory.
DQ_RS = r"""__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

RS_KK
template <int D>
__device__ __forceinline__ void dq_frags(uint32_t (&f)[D / 16][4],
                                         const unsigned char* wt, int warp,
                                         int lane) {
  const int r = warp * 16 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(f[kk], wt + kk / 4 * BOX + r * 128 +
                       ((((kk % 4) * 2 + (lane >> 4)) ^ (r & 7)) << 4));
}

template <int D>
__device__ __forceinline__ void dq_scores_rs(float (&s)[8][4],
                                             const uint32_t (&fa)[D / 16][4],
                                             const unsigned char* kt) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t db = sw128_desc_at(kt + kk / 4 * KBOX + kk % 4 * 32, 16,
                                      1024);
    if (kk == 0)
      wgmma_rs_kk_first(s, fa[kk], db);
    else
      wgmma_rs_kk(s, fa[kk], db);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

""".replace("RS_KK\n", RS_KK_TEXT)

DQ_SCORES = """    dq_scores<D>(s, qw, kt);
    dq_scores<D>(dp, dow, vt);
"""


DQ_SKIP = """  if (j < nk) {
    // the block's last k tile lies wholly above this warpgroup's rows: its
    // two turns pass with no products. It still waits for the tile's load
    // before counting out, so that a parity wait never meets a phase that
    // has not begun. (Only warpgroup 0 comes here.)
    turn_wait(wg);
    turn_pass(wg);
    turn_wait(wg);
    turn_pass(wg);
    mbar_wait(&full[j % DQ_STAGES], (j / DQ_STAGES) & 1);
    release(j);
  }
"""


def _dq_step_a(text):
    """64-key tiles: a warpgroup skips the tiles wholly above its diagonal
    (warpgroup 0 the block's last one), still waiting for each phase."""
    text = _sub(text, "constexpr int DQ_BN = 128;", "constexpr int DQ_BN = 64;",
                kernel_only=False)
    nk = "  if (a.causal) nk = min(nk, (min(q0 + FT, a.Sq) - 1) / DQ_BN + 1);\n"
    text = _sub(text, nk, nk + "  const int nw = a.causal ? min(nk, (r0 + 63)"
                " / DQ_BN + 1) : nk;\n", kernel="dq")
    text = _sub(text, "  for (int j = 0; j < nk; ++j) {",
                "  int j = 0;\n  for (; j < nw; ++j) {", kernel="dq")
    return _sub(text, "    release(j);\n  }\n\n",
                "    release(j);\n  }\n" + DQ_SKIP + "\n", kernel="dq")


def _dq_step_b(text):
    text = _dq_step_a(text)
    k = text.index("template <int D>\n__global__ void __launch_bounds__"
                   "(FWD_THREADS, 1)\n" + DQ_KERNEL)
    text = text[:k] + DQ_RS + text[k:]
    text = _sub(text, "  mbar_wait(&qfull, 0);\n", """  mbar_wait(&qfull, 0);
  // the warp's rows of Q and dO as A fragments, for the whole loop
  uint32_t qa[D / 16][4], oa[D / 16][4];
  dq_frags<D>(qa, qw, warp, lane);
  dq_frags<D>(oa, dow, warp, lane);
  reg_fence_all(qa);
  reg_fence_all(oa);
""", kernel="dq")
    return _sub(text, DQ_SCORES, """    dq_scores_rs<D>(s, qa, kt);
    dq_scores_rs<D>(dp, oa, vt);
""", kernel="dq")


def _dq_no_exp(text):
    return _sub(text, "s[n][e] = expf(__fsub_rn(s[n][e], lse[e >> 1]));",
                "s[n][e] = __fsub_rn(s[n][e], lse[e >> 1]);", kernel="dq")


def _dq_no_scores(text):
    return _sub(text, DQ_SCORES, """#pragma unroll
    for (int n = 0; n < DQ_BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        asm volatile("mov.b32 %0, 0f3C000000;" : "=f"(s[n][e]));
        asm volatile("mov.b32 %0, 0f3C000000;" : "=f"(dp[n][e]));
      }
""", kernel="dq")


DQ_VARIANTS = {"as_is": lambda t: t,
               "no_turns": lambda t: _no_turns(t, "dq"),
               "step_a": _dq_step_a}
DQ_ABLATIONS = {"step_b": _dq_step_b, "no_exp": _dq_no_exp,
                "no_scores": _dq_no_scores}
# kernel: (checked variants, timed-only ones, its symbol in ptxas's report)
KERNELS = {"dkv": (VARIANTS, ABLATIONS, "flash_dkv_bf16"),
           "dq": (DQ_VARIANTS, DQ_ABLATIONS, "flash_dq_bf16")}


def write_sources(names, out_dir, kernel="dkv"):
    """Each variant's flash_attention.cu (and the shared header) under
    out_dir/<name>/; returns {name: source path}."""
    with open(os.path.join(CSRC, "flash_attention.cu")) as f:
        text = f.read()
    with open(os.path.join(CSRC, "sm90.cuh")) as f:
        header = f.read()
    variants, ablations, _ = KERNELS[kernel]
    paths = {}
    for name in names:
        edit = variants.get(name) or ablations[name]
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


def build(paths, kernel="dkv"):
    """One nvcc per variant, all at once; returns {name: library path} of
    those that built, printing the probed kernel's ptxas report (and any
    note of ptxas's on its wgmma)."""
    from mxnet_tpu_torch.kernels import _build
    symbol = KERNELS[kernel][2]
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
            if "Compiling entry function" in ln and symbol in ln:
                d = "D128" if "Li128" in ln else "D64"
                report[d] = " | ".join(x.strip() for x in lines[i + 1:i + 4]
                                       if "Function properties" not in x)
        emit({"variant": name, "built": proc.returncode == 0,
              "ptxas_" + kernel: report,
              "wgmma_notes": [ln.strip() for ln in lines
                              if "wgmma" in ln and symbol in ln][:4],
              "errors": [ln for ln in lines if " error" in ln][:5]})
        if proc.returncode == 0:
            libs[name] = lib
    return libs


def worker(kernel, name, lib, check):
    """Checks (unless an ablation) and times one variant of a kernel."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import flash_attention as FA
    _build._LIBS["flash_attention"] = ctypes.CDLL(lib)
    torch.backends.cuda.matmul.allow_tf32 = False
    # the kernel's outputs among (dq, dk, dv)
    mine = (0,) if kernel == "dq" else (1, 2)
    out = {"kernel": kernel, "variant": name}
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
            if not all(torch.equal(outs[2 + i], again[i]) for i in mine):
                bad.append([list(case), "second launch bits"])
            bad += [[list(case), n] for n in res if not res[n]["ok"]]
        out["checks_ok"] = not bad
        out["failures"] = bad[:5]
    B, H, S, D = cs.LM_BATCH, cs.LM_CFG["n_heads"], cs.LM_SEQ, 128
    q, k, v, do = cs.flash_case(torch, (B, H, S, S, D, True),
                                torch.bfloat16, seed=1200)
    o, lse = FA._flash_forward(q, k, v, True, D ** -0.5)
    delta = (do.float() * o.float()).sum(dim=-1).reshape(B * H, S)
    grads = tuple(torch.empty_like(t) for t in (q, k, v))
    outs = [grads[i] for i in mine]
    stream = torch.cuda.current_stream().cuda_stream
    fn = FA._fn("flash_" + kernel)
    strides = FA._strides(q, k, v, do, *outs)
    head = (0, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    tail = (B * H, H, S, S, D, 1, D ** -0.5, strides, stream)

    def launch():
        err = fn(*(head + tuple(t.data_ptr() for t in outs) + tail))
        if err:
            raise RuntimeError("flash_%s launch failed: cudaError %d"
                               % (kernel, err))
    if check:
        launch()
        first = [t.clone() for t in outs]
        same = True
        for _ in range(10):
            launch()
            torch.cuda.synchronize()
            same = same and all(torch.equal(a, b)
                                for a, b in zip(outs, first))
        out["lm_shape_same_bits_10_launches"] = same
        out["checks_ok"] = out["checks_ok"] and same
    out["ms"] = [cs.device_ms(torch, launch, iters=20) for _ in range(2)]
    emit(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="dkv")
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--sources", help="write the variants' sources to this "
                    "directory and stop")
    ap.add_argument("--worker", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        name, lib, check = args.worker
        worker(args.kernel, name, lib, check == "1")
        return 0
    variants, ablations, _ = KERNELS[args.kernel]
    names = args.variants or list(variants) + list(ablations)
    unknown = set(names) - set(variants) - set(ablations)
    if unknown:
        ap.error("unknown %s variants %s" % (args.kernel, sorted(unknown)))
    if args.sources:
        write_sources(names, args.sources, args.kernel)
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
    out_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build", "probe",
                           args.kernel)
    libs = build(write_sources(names, out_dir, args.kernel), args.kernel)
    built = [n for n in names if n in libs]
    ms, ok = {n: [] for n in built}, {}
    for turn in (built, built[::-1]):
        for name in turn:
            check = name in variants and name not in ok
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--kernel", args.kernel,
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
    emit({"smi": smi, "kernel": args.kernel,
          "shape_bhsd": [12, 32, 2048, 2048, 128], "causal": True,
          "ms_per_launch_in_turns": ms, "checks_ok": ok})
    return 0 if all(ok.values()) and len(built) == len(names) else 1


if __name__ == "__main__":
    sys.exit(main())

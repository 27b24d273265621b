"""The port's kernel build (mxnet_tpu_torch/kernels/_build.py) on the CPU:
the library name each source builds to, which must change whenever the
source, a shared header in csrc/ or the flags change, so that a stale
library is never loaded. Nothing here runs nvcc."""
import importlib.util
import os
import re

import pytest

from mxnet_tpu_torch.kernels import _build

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mxnet_tpu_torch", "csrc")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A temporary csrc/ with one source that includes one header."""
    (tmp_path / "k.cu").write_text('#include "hopper.cuh"\nint k();\n')
    (tmp_path / "hopper.cuh").write_text("int helper();\n")
    monkeypatch.setattr(_build, "_SRC_DIR", str(tmp_path))
    return tmp_path


def _lib(name="k"):
    return os.path.basename(_build._target(name)[1])


def test_key_is_stable(csrc):
    assert _lib() == _lib()
    assert re.fullmatch(r"libk-[0-9a-f]{16}\.so", _lib())


def test_key_changes_with_a_header(csrc):
    before = _lib()
    (csrc / "hopper.cuh").write_text("int helper(int);\n")
    assert _lib() != before


def test_key_changes_with_a_new_header(csrc):
    before = _lib()
    (csrc / "more.cuh").write_text("int other();\n")
    assert _lib() != before


def test_key_changes_with_the_source_and_flags(csrc, monkeypatch):
    before = _lib()
    (csrc / "k.cu").write_text('#include "hopper.cuh"\nint k(int);\n')
    edited = _lib()
    assert edited != before
    monkeypatch.setattr(_build, "_FLAGS", _build._FLAGS + ["-DX"])
    assert _lib() != edited


def test_key_ignores_other_files(csrc):
    before = _lib()
    (csrc / "notes.txt").write_text("not a header\n")
    assert _lib() == before


def test_every_source_has_its_own_library():
    libs = [_lib(name) for name in _build.SOURCES]
    assert len(set(libs)) == len(libs)
    for name, lib in zip(_build.SOURCES, libs):
        assert lib.startswith("lib%s-" % name)


# The Hopper primitives that the TMA, bulk-copy and wgmma kernels
# (conv_fused, flash_attention, quantized_matmul, batchnorm_fused,
# compression) use live once, in csrc/sm90.cuh.
HOPPER = ("conv_fused.cu", "flash_attention.cu", "quantized_matmul.cu",
          "batchnorm_fused.cu", "compression.cu", "sm90.cuh")
SHARED = ("smem_addr", "mbar_init", "mbar_arrive", "mbar_expect_tx",
          "mbar_wait", "tma_load4", "tma_store4", "bulk_load", "bulk_store",
          "reg_fence", "sw128_desc", "sw128_desc_at", "wgmma_rs", "wgmma_ss",
          "wgmma_ss_kk", "wgmma_ss_kk_first", "count_last", "encode_tiled")


@pytest.mark.parametrize("name", SHARED)
def test_hopper_primitives_have_one_copy(name):
    pattern = re.compile(r"^(?:__device__ __forceinline__ \S+|int) %s\("
                         % name, re.M)
    defined = [f for f in HOPPER
               if pattern.search(open(os.path.join(CSRC, f)).read())]
    assert defined == ["sm90.cuh"], defined


@pytest.mark.parametrize("source", ["conv_fused", "flash_attention",
                                    "quantized_matmul", "batchnorm_fused",
                                    "compression"])
def test_hopper_kernels_include_the_shared_header(source):
    text = open(os.path.join(CSRC, source + ".cu")).read()
    assert '#include "sm90.cuh"' in text


def _flash_probe():
    path = os.path.join(os.path.dirname(CSRC), os.pardir,
                        "chip_flash_probe.py")
    spec = importlib.util.spec_from_file_location("chip_flash_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# chip_flash_probe.py builds its variants of the dK/dV and the dQ kernel
# by editing csrc/flash_attention.cu's text: each edit must still apply to
# the source, change only its kernel (and the named constants it names),
# and keep the rest.
DKV_PROBES = ["as_is", "no_turns", "early_dv", "stages3", "step_b", "no_exp",
              "no_elementwise", "no_scores"]
DQ_PROBES = ["as_is", "no_turns", "step_a", "step_b", "no_exp", "no_scores"]


@pytest.mark.parametrize("kernel,name", [
    pytest.param("dkv", n, id=n) for n in DKV_PROBES] + [
    pytest.param("dq", n, id="dq-" + n) for n in DQ_PROBES])
def test_flash_probe_variants_apply(kernel, name, tmp_path):
    probe = _flash_probe()
    variants, ablations, _ = probe.KERNELS[kernel]
    assert set(variants) | set(ablations) >= {name}
    src = open(os.path.join(CSRC, "flash_attention.cu")).read()
    out = open(probe.write_sources([name], str(tmp_path), kernel)[name]) \
        .read()
    assert (out == src) == (name == "as_is")
    assert open(os.path.join(tmp_path, name, "sm90.cuh")).read() == \
        open(os.path.join(CSRC, "sm90.cuh")).read()
    start, end = probe.REGIONS[kernel]
    cut = src.index(start)
    head = src[:cut]
    if (kernel, name) in (("dkv", "early_dv"), ("dq", "step_b")):
        # adds its helpers before the kernel
        head = head.rsplit("template <int D>", 1)[0]
    if (kernel, name) in (("dkv", "stages3"), ("dkv", "step_b")):
        head = head.replace("DKV_STAGES = 2;", "DKV_STAGES = 3;")
    if (kernel, name) in (("dq", "step_a"), ("dq", "step_b")):
        head = head.replace("DQ_BN = 128;", "DQ_BN = 64;")
    assert out.startswith(head)
    assert out.endswith(src[src.index(end, cut):])


def test_flash_probe_regions_hold_one_kernel_each():
    """The dK/dV region ends where the dQ section begins, so that an edit
    of one kernel never reaches the other."""
    probe = _flash_probe()
    src = open(os.path.join(CSRC, "flash_attention.cu")).read()
    spans = {k: probe._region(src, k) for k in probe.REGIONS}
    for k, (a, b) in spans.items():
        body = src[a:b]
        for other, (start, _) in probe.REGIONS.items():
            assert (start in body) == (other == k), (k, other)


def _qmm_probe():
    path = os.path.join(os.path.dirname(CSRC), os.pardir, "chip_qmm_probe.py")
    spec = importlib.util.spec_from_file_location("chip_qmm_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# chip_qmm_probe.py builds its variants of the int8 matmul's wgmma route by
# editing csrc/quantized_matmul.cu's text: each edit must still apply and
# change only the wgmma route's section (its named constants included).
@pytest.mark.parametrize("name", ["as_is", "m_fastest", "staging2",
                                  "staging2_bn64", "prefetch", "no_split",
                                  "split_more"])
def test_qmm_probe_variants_apply(name, tmp_path):
    probe = _qmm_probe()
    assert name in probe.VARIANTS
    src = open(os.path.join(CSRC, "quantized_matmul.cu")).read()
    out = open(probe.write_sources([name], str(tmp_path))[name]).read()
    # the plans build the source as it is and set qmm_plan's constants
    assert (out == src) == (name == "as_is" or name in probe.PLANS)
    assert open(os.path.join(tmp_path, name, "sm90.cuh")).read() == \
        open(os.path.join(CSRC, "sm90.cuh")).read()
    start = src.index(probe.START)
    end = src.index(probe.END)
    assert out.startswith(src[:start])
    assert out.endswith(src[end:])


def _conv_probe():
    path = os.path.join(os.path.dirname(CSRC), os.pardir,
                        "chip_conv_probe.py")
    spec = importlib.util.spec_from_file_location("chip_conv_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# chip_conv_probe.py builds its variants of the bf16 conv_fused forward by
# editing csrc/conv_fused.cu's text: each edit must still apply and change
# only the forward kernel's section, except that the trace adds its copy
# function to the C interface.
@pytest.mark.parametrize("name", ["as_is", "trace", "depth2", "depth3",
                                  "batch1", "batch5", "no_act", "no_store"])
def test_conv_probe_variants_apply(name, tmp_path):
    probe = _conv_probe()
    assert name in probe.VARIANTS
    src = open(os.path.join(CSRC, "conv_fused.cu")).read()
    out = open(probe.write_sources([name], str(tmp_path))[name]).read()
    assert (out == src) == (name == "as_is")
    assert open(os.path.join(tmp_path, name, "sm90.cuh")).read() == \
        open(os.path.join(CSRC, "sm90.cuh")).read()
    start = src.index(probe.START)
    end = src.index(probe.END)
    assert out.startswith(src[:start])
    tail = src[end:]
    if name == "trace":
        tail = tail.replace('extern "C" {\n', probe.TRACE_FETCH, 1)
    assert out.endswith(tail)


def _bn_probe():
    path = os.path.join(os.path.dirname(CSRC), os.pardir, "chip_bn_probe.py")
    spec = importlib.util.spec_from_file_location("chip_bn_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# chip_bn_probe.py builds its variants of the BatchNorm folds by editing
# csrc/batchnorm_fused.cu's text: each edit must still apply, and leave the
# elementwise kernels (rows 5 and 7) as they are.
@pytest.mark.parametrize("name", ["as_is", "stages2", "warps4", "bwd128",
                                  "pdl", "items2x"])
def test_bn_probe_variants_apply(name, tmp_path):
    probe = _bn_probe()
    assert name in probe.VARIANTS
    src = open(os.path.join(CSRC, "batchnorm_fused.cu")).read()
    out = open(probe.write_sources([name], str(tmp_path))[name]).read()
    # the plans build the source as it is and change fold_plan's SM count
    assert (out == src) == (name == "as_is" or name in probe.PLANS)
    assert open(os.path.join(tmp_path, name, "sm90.cuh")).read() == \
        open(os.path.join(CSRC, "sm90.cuh")).read()
    start = src.index("// row 5: out = act")
    end = src.index("// launch helpers")
    assert out[out.index("// row 5: out = act"):
               out.index("// launch helpers")] == src[start:end]


def _codec_probe():
    path = os.path.join(os.path.dirname(CSRC), os.pardir,
                        "chip_codec_probe.py")
    spec = importlib.util.spec_from_file_location("chip_codec_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# chip_codec_probe.py builds its variants of the codec kernels by editing
# csrc/compression.cu's text: each edit must still apply, change only the
# kernel it names, and keep the shared header.
@pytest.mark.parametrize("name", ["as_is", "b2s3", "vec8", "dq_direct",
                                  "per_tensor"])
def test_codec_probe_variants_apply(name, tmp_path):
    probe = _codec_probe()
    assert name in probe.VARIANTS
    src = open(os.path.join(CSRC, "compression.cu")).read()
    out = open(probe.write_sources([name], str(tmp_path))[name]).read()
    assert (out == src) == (name in ("as_is", "per_tensor"))
    assert open(os.path.join(tmp_path, name, "sm90.cuh")).read() == \
        open(os.path.join(CSRC, "sm90.cuh")).read()
    dq = "__global__ void __launch_bounds__(WARPS * 32)\ncodec_dequantize"
    if name != "dq_direct":      # the quantize edits leave dequantize alone
        assert out[out.index(dq):] == src[src.index(dq):]
    else:
        assert out[:out.index(dq)] == src[:src.index(dq)]

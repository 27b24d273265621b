"""The port's roofline join (mxnet_tpu_torch/_debug/perfmodel.py) against
the JAX package's (mxnet_tpu/_debug/perfmodel.py), and the port's modeled
side: the cost count of one step (mxnet_tpu_torch/kernels/_cost.py).

The same note_compile/note_step sequences, with the same hardware
assumptions injected into both modules, give equal table(), snapshot()
and manifest_block(), and the collapse detector trips at the same step
with one dump each. The count of a narrow NHWC ResNet's fused step equals
the analytic count of its convolutions and dense layer
(chip_smoke.resnet_v1_step_flops: 2 x multiply-adds, the forward and both
backward products), and each kernel wrapper counts its declared cost()
and nothing inside it.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu._debug.perfmodel as jperf
import mxnet_tpu.profiler as jprof
import mxnet_tpu_torch as mx
import mxnet_tpu_torch._debug.perfmodel as tperf
import mxnet_tpu_torch.profiler as tprof
from mxnet_tpu_torch._debug import flightrec, goodput, watchdog
from mxnet_tpu_torch.gluon import fused_step
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.kernels import _cost
from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
from mxnet_tpu_torch.kernels import box_nms as NMS
from mxnet_tpu_torch.kernels import compression as CMP
from mxnet_tpu_torch.kernels import conv_fused as CF
from mxnet_tpu_torch.kernels import flash_attention as FA
from mxnet_tpu_torch.kernels import optimizer_apply as OA
from mxnet_tpu_torch.kernels import quantized_matmul as QM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOTH = (jperf, tperf)
ASSUME = {"chip": "test card", "hbm_bw_GBps": 819.0,
          "peak_tflops": {"bf16": 197.0, "f16": 197.0, "f32": 98.5,
                          "int8": 394.0}}
NARROW = ([1, 1, 1, 1], [16, 32, 64, 128, 256])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def both(monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_RUNS_DIR", str(tmp_path / "runs"))
    monkeypatch.setenv("MXTPU_FLIGHTREC_DIR", str(tmp_path / "frec"))
    for m in BOTH:
        m.reset()
        monkeypatch.setattr(m, "_assumptions", lambda: ASSUME)
    yield BOTH
    for m in BOTH:
        m.reset()


# -- the join: the same sequences into both packages --------------------------

def _seq_basic(m):
    m.note_compile("fused_step", "0000cafe", flops=2e9, bytes_accessed=3e8,
                   args={"peak_tflops": 98.5, "dtype": "f32", "dp": 1})
    for d in (1e-3, 1.2e-3, 0.9e-3, 1.1e-3, 1e-3, 1.05e-3):
        m.note_step("fused_step:0000cafe", d)


def _seq_bounds(m):
    for key, flops, nbytes, comm, dur in (
            ("c", 1e12, None, None, 0.011), ("m", 1e6, 8.19e9, None, 0.011),
            ("n", 1e6, None, 10000.0, 0.012), ("o", 1e6, None, None, 0.01)):
        m.note_compile("prog", key, flops=flops, bytes_accessed=nbytes,
                       modeled_comm_us=comm, args={"peak_tflops": 100.0})
        for _ in range(4):
            m.note_step("prog:" + key, dur)
    # measured without a model, and a model never measured
    for _ in range(3):
        m.note_step("ghost:1", 2e-3)
    m.note_compile("cold", "2", flops=1e9, args={})


def _seq_window(m):
    m.configure(window=3, min_samples=2)
    m.note_compile("w", "1", flops=4e9, bytes_accessed=1e8,
                   args={"dtype": "bf16", "peak_tflops": 197.0})
    for i in range(9):
        m.note_step("w:1", 1e-3 * (1 + (i % 4)))


@pytest.mark.parametrize("script", [_seq_basic, _seq_bounds, _seq_window])
def test_join_equals_jax(both, script):
    for m in both:
        script(m)
        m.fold_pending()
    j, t = both
    assert t.table() == j.table()
    assert t.snapshot() == j.snapshot()
    assert t.manifest_block() == j.manifest_block()
    assert t.manifest_block()["schema"] == "mxtpu.perf/1"


def test_collapse_trips_at_the_same_step_once_each(both, monkeypatch,
                                                   tmp_path):
    """A sustained collapse trips ONE perf dump per episode at the same
    step in both packages, with the same trip payload; collapsed steps
    stay out of the windows; a clean step re-arms."""
    durs = [1e-3] * 6 + [4e-3] * 4 + [1e-3] * 2 + [5e-3] * 2
    trips, payloads = [], []
    for m, d in zip(both, ("jax", "torch")):
        monkeypatch.setenv("MXTPU_FLIGHTREC_DIR", str(tmp_path / d))
        m.configure(min_samples=5, mfu_drop=0.5)
        m.note_compile("fused_step", "beef", flops=2e9,
                       args={"peak_tflops": 98.5})
        at, before = [], 0
        for i, dur in enumerate(durs):
            m.note_step("fused_step:beef", dur)
            m.fold_pending()     # the poller's drain: dumps fire here
            after = m.snapshot()["collapse_dumps"]
            if after > before:
                at.append(i)
            before = after
        trips.append(at)
        files = sorted(f for f in os.listdir(tmp_path / d) if "_perf_" in f)
        assert len(files) == 2
        payloads.append([json.load(open(tmp_path / d / f))["metadata"]
                         ["trigger_info"] for f in files])
    assert trips[0] == trips[1] == [6, 12]
    assert payloads[0] == payloads[1]
    j, t = both
    assert t.snapshot() == j.snapshot()
    assert t.snapshot()["collapses"] == 6


def test_card_table_and_hardware_model():
    assert tperf.card("NVIDIA H100 80GB HBM3")[0] == "H100"
    assert tperf.card("NVIDIA H100 PCIe")[0] == "H100 PCIe"
    assert tperf.card("cpu") is None
    a = tperf.assumptions_for("NVIDIA H100 80GB HBM3")
    assert a["peak_tflops"] == {"bf16": 989.0, "f16": 989.0, "f32": 67.0,
                                "int8": 1979.0}
    assert a["hbm_bw_GBps"] == 3350.0
    assert tperf.peak_tflops("bf16", a) == 989.0
    assert tperf.peak_tflops("f64", a) == 989.0
    assert tperf.peak_tflops("bf16", None) is None
    # this process never initialised CUDA: no model, rows carry no mfu
    assert tperf._assumptions() is None


# -- the surfaces -------------------------------------------------------------

def _roofline(text):
    lines = text.splitlines()
    i = [k for k, ln in enumerate(lines) if ln.startswith("Roofline")]
    return lines[i[0]:] if i else []


def test_surfaces(both, monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_FLIGHTREC_DIR", str(tmp_path / "frec"))
    for m in both:
        _seq_basic(m)
    t_rows, j_rows = _roofline(tprof.dumps()), _roofline(jprof.dumps())
    assert t_rows == j_rows and len(t_rows) == 2
    m = tprof.metrics()["perf"]
    assert m["hot_signature"] == "fused_step:0000cafe"
    text = tprof.prometheus_text()
    for fam in ("mxtpu_mfu{", "mxtpu_membw_util{", "mxtpu_roofline_bound{"):
        assert fam in text
    path = flightrec.dump("test")
    meta = json.load(open(path))["metadata"]
    assert meta["perf"]["per_signature"]["fused_step:0000cafe"]["steps"] == 6
    goodput.reset()
    goodput.open_run("perf-test")
    man = goodput.close_run()
    assert man["perf"]["signatures"]["fused_step:0000cafe"]["steps"] == 6
    goodput.reset()
    tprof._reset()   # the profiler's reset clears the join too
    assert tperf.snapshot()["signatures"] == 0


def test_watchdog_beacon_feeds_the_join(both):
    watchdog.reset()
    try:
        for warm in (True, False, False):
            watchdog.step_begin()
            watchdog.step_end(warmup=warm, mode="fused", sig="sig:1")
        watchdog.step_begin()
        watchdog.step_end(mode="fused")          # untagged: no join
        tperf.fold_pending()
        assert tperf.snapshot()["per_signature"]["sig:1"]["steps"] == 2
        assert tperf.snapshot()["signatures"] == 1
    finally:
        watchdog.reset()


# -- the modeled side: the cost count ----------------------------------------

def _narrow_step(fused_apply):
    net = tres.ResNetV1(tres.BottleneckV1, *NARROW, classes=10,
                        thumbnail=True, layout="NHWC", fuse=True)
    net.initialize(ctx=mx.cpu())
    net(torch.zeros(1, 3, 32, 32))
    mx.convert.load_numpy_params(net, mx.convert.random_numpy_params(
        mx.convert.param_shapes(net), seed=3))
    net.hybridize()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.01, "momentum": 0.9})
    loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    return net, tr, mx.gluon.train_step(net, loss, tr)


def _batch(n=2):
    rs = np.random.RandomState(1)
    return (torch.from_numpy(rs.rand(n, 3, 32, 32).astype("float32")),
            torch.from_numpy(rs.randint(0, 10, (n,)).astype("float32")))


def test_step_count_equals_the_analytic_count(monkeypatch):
    """The first fused step of a signature records its modeled work as
    fused_step:<crc32> (the beacon's tag); its flops equal the analytic
    count; a later step counted from outside gives the same numbers, one
    launch scope per kernel launch and per packed bucket."""
    monkeypatch.setenv("MXTPU_FUSED_APPLY", "1")
    tperf.reset()
    tprof._reset()
    cs = _chip_smoke()
    want = cs.resnet_v1_step_flops(NARROW[0], NARROW[1], 2, 32, 10,
                                   thumbnail=True)
    net, tr, step = _narrow_step(True)
    x, y = _batch()
    with mx.cpu():
        step(x, y)
        rec = tprof.compile_stats()["fused_step"]
        sig = fused_step._signature((x, y))
        assert rec["key"] == sig.split(":", 1)[1]
        assert rec["flops"] == want
        with _cost.counting() as c:
            step(x, y)
    assert c.flops == want and c.bytes == rec["bytes_accessed"]
    assert c.vector_ops > 0
    links = sum(1 for m in net.modules() if getattr(m, "_fuse", False))
    assert c.kernels["conv_fused.fwd"] == c.kernels["conv_fused.bwd"] \
        == links == 4
    ws = [p._tensor() for p in tr._params if p.grad_req != "null"]
    assert c.kernels["optimizer_apply"] == len(OA.bucketize(ws))
    assert len({c.kernels["batchnorm_fused." + k] for k in BNF.OPS}) == 1
    tperf.fold_pending()
    row = tperf.snapshot()["per_signature"][sig]
    assert row["flops"] == want and row["steps"] == 2
    assert row["mfu"] is None      # no card: no peak, no mfu
    tperf.reset()
    tprof._reset()


def test_perf_plane_is_free_of_effect(monkeypatch):
    """MXTPU_PERF=1 training (the first step under the dispatch mode) is
    bit for bit MXTPU_PERF=0 training."""
    params = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("MXTPU_PERF", flag)
        tperf.reset()
        net, tr, step = _narrow_step(False)
        x, y = _batch()
        with mx.cpu():
            for _ in range(2):
                step(x, y)
        params[flag] = [p._tensor().clone()
                        for p in net.collect_params().values()]
    tperf.reset()
    assert all(torch.equal(a, b) for a, b in zip(params["0"], params["1"]))


def _conv_args(relu=True):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 6, 8, generator=g)
    s, b = torch.rand(8, generator=g) + 0.5, torch.randn(8, generator=g)
    w = torch.randn(3, 3, 8, 12, generator=g) * 0.1
    return x, s, b, w


def _case_conv_fwd():
    x, s, b, w = _conv_args()
    return (lambda: CF.fused_scale_relu_conv3x3(x, s, b, w),
            CF.cost((2, 5, 6, 8, 12), 4), True)


def _case_conv_bwd():
    x, s, b, w = _conv_args()
    dy = torch.randn(2, 5, 6, 12)
    fx, bx = CF.cost((2, 5, 6, 8, 12), 4, "bwd_dx")
    fw, bw = CF.cost((2, 5, 6, 8, 12), 4, "bwd_dw")
    return (lambda: CF.fused_conv_backward(x, s, b, w, dy),
            (fx + fw, bx + bw), True)


def _bn_case(kernel):
    g = torch.Generator().manual_seed(1)
    x2 = torch.randn(96, 24, generator=g)
    dy2 = torch.randn(96, 24, generator=g)
    gamma, beta = torch.rand(24, generator=g), torch.randn(24, generator=g)
    mean, var = BNF.stats_reference(x2)
    db, dg = BNF.bwd_reduce_reference(x2, dy2, gamma, beta, mean, var)
    call = {"stats": lambda: BNF.stats(x2),
            "apply": lambda: BNF.apply(x2, gamma, beta, mean, var),
            "bwd_reduce": lambda: BNF.bwd_reduce(x2, dy2, gamma, beta, mean,
                                                 var),
            "bwd_dx": lambda: BNF.bwd_dx(x2, dy2, gamma, beta, mean, var,
                                         db, dg)}[kernel]
    return call, BNF.cost((96, 24), kernel, 4), False


def _case_apply():
    opt = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9)
    ws = [torch.randn(7), torch.randn(3, 4)]
    gs = [torch.randn(7), torch.randn(3, 4)]
    ms = [torch.zeros(7), torch.zeros(3, 4)]
    return (lambda: OA.packed_apply(opt, ws, gs, ms, [0.1, 0.1], [0.0, 0.0],
                                    1.0),
            OA.cost("sgd_momentum", 19, 2, 4), False)


def _case_flash():
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(1, 2, 16, 64, generator=g) for _ in range(3))
    return (lambda: FA.flash_attention(q, k, v, causal=True),
            FA.cost("fwd", 1, 2, 16, 16, 64, True, 4), True)


def _case_qmm():
    g = torch.Generator().manual_seed(3)
    x = torch.randint(-127, 128, (5, 16), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (16, 3), generator=g, dtype=torch.int8)
    s = torch.rand(3, generator=g)
    return (lambda: QM.quantized_matmul(x, w, s), QM.cost(5, 16, 3, True),
            True)


def _case_quantize():
    g, r = torch.randn(40), torch.zeros(40)
    return (lambda: CMP.quantize_2bit(g, r, 0.5),
            CMP.cost("quantize", 40, CMP.num_words(40), 4), False)


def _case_dequantize():
    words = torch.zeros(CMP.num_words(40), dtype=torch.int32)
    return (lambda: CMP.dequantize_2bit(words, 40, 0.5),
            CMP.cost("dequantize", 40, CMP.num_words(40), 4), False)


def _case_nms():
    boxes = torch.tensor([[[0, 0, 1, 1], [0, 0, 1, 1.1], [2, 2, 3, 3],
                           [0, 0, 0.9, 1]]], dtype=torch.float32)
    ids = torch.tensor([[0, 0, 1, 0]], dtype=torch.float32)
    nvalid = torch.tensor([4])
    # class 0 holds 3 valid boxes: 3 pairs
    return (lambda: NMS.keep(boxes, ids, nvalid, 0.5),
            (3 * NMS.IOU_OPS, 16 * 4 + 4 * 4 + 4), False)


CASES = {"conv_fwd": _case_conv_fwd, "conv_bwd": _case_conv_bwd,
         "apply": _case_apply, "flash_fwd": _case_flash, "qmm": _case_qmm,
         "quantize": _case_quantize, "dequantize": _case_dequantize,
         "nms": _case_nms,
         **{"bn_" + k: (lambda k=k: _bn_case(k)) for k in BNF.OPS}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_counts_its_declared_cost_only(case):
    """On the CPU a wrapper runs its plain version (aten ops); under the
    count it adds its declared cost() and nothing of what runs inside."""
    fn, (flops, nbytes), tensor_core = CASES[case]()
    with _cost.counting() as c:
        fn()
    assert (c.flops, c.vector_ops) == ((flops, 0.0) if tensor_core
                                       else (0.0, flops))
    assert c.bytes == nbytes
    assert sum(c.kernels.values()) == 1


def test_aten_ops_count_flops_and_bytes():
    a, b = torch.randn(4, 8), torch.randn(8, 3)
    with _cost.counting() as c:
        out = a @ b
        out.t()            # a view: moves nothing, counts nothing
        out.relu()
    assert c.flops == 2 * 4 * 8 * 3
    assert c.bytes == 4 * (32 + 24 + 12) + 4 * (12 + 12)
    with pytest.raises(RuntimeError, match="already open"):
        with _cost.counting():
            with _cost.counting():
                pass

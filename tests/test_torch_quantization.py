"""The port's int8 quantization (mxnet_tpu_torch/contrib/quantization.py and
the quantized-state carrier in mxnet_tpu_torch/convert.py) held against
the JAX package's (mxnet_tpu/contrib/quantization.py).

The networks get the same float weights (numpy arrays from a seed, or read
off the JAX network), the same calibration batches and the same inputs.
Weight quantization is exact IEEE arithmetic, so int8 weights and scales
must be equal bit for bit. Thresholds are the max |input| of each layer
over the calibration batches, so they differ only where the float layers
before them do (summation order: the narrow ResNet's float logits agree to
about 2e-7 of their max); they must agree to 1e-5 relative. Under one
carried state (the JAX network's int8 weights and thresholds loaded into
the port) the int8 forwards compute the same codes, and since every float
step between the int8 layers is the same IEEE operation in both packages
on this network, the logits are equal bit for bit.

A bf16 two-Dense network and bf16 ``quantize`` follow JAX's type promotion
(weight scales and input codes in bf16) and are equal bit for bit, logits
included; the int8 state keeps no autograd history.

A full ResNet-50 takes over half a minute per JAX quantize_net on the CPU,
so these tests use a narrow one (one bottleneck per stage, widths 16-256,
the 7x7 stem, 32x32 images); chip_smoke.py runs the full width on the
card.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.kernels import quantized_matmul as QM

LAYERS, CHANNELS = [1, 1, 1, 1], [16, 32, 64, 128, 256]
THRESHOLD_RTOL = 1e-5


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _jax_state(net):
    """The JAX network's int8 layers in ``convert.quantized_state``'s
    form."""
    return {path: {"wq": np.asarray(c._wq),
                   "w_scale": np.asarray(c._w_scale),
                   "act_scale": c._act_scale,
                   "bias": None if c._bias is None else np.asarray(c._bias)}
            for _, _, path, c in jq._walk_children(net)
            if isinstance(c, (jq._QuantizedDense, jq._QuantizedConv2D))}


def _resnets():
    x0 = np.zeros((2, 3, 32, 32), np.float32)
    jnet = jres.ResNetV1(jres.BottleneckV1, LAYERS, CHANNELS, classes=10)
    jnet.initialize()
    jnet(mxj.nd.array(x0))
    jparams = jnet._collect_params_with_prefix()
    arrays = convert.random_numpy_params(
        {k: p.shape for k, p in jparams.items()}, seed=3)
    for k, p in jparams.items():
        p.set_data(mxj.nd.array(arrays[k]))
    tnet = tres.ResNetV1(tres.BottleneckV1, LAYERS, CHANNELS, classes=10)
    tnet.initialize(ctx=mx.cpu())
    convert.load_numpy_params(tnet, arrays)
    return jnet, tnet


@pytest.fixture(scope="module")
def resnet():
    """Both narrow ResNets, float logits, then quantize_net (naive, two
    calibration batches) on each; the int8 logits of each under its own
    state."""
    jnet, tnet = _resnets()
    rs = np.random.RandomState(2)
    calib = [rs.rand(2, 3, 32, 32).astype(np.float32) for _ in range(2)]
    x = np.random.RandomState(7).rand(2, 3, 32, 32).astype(np.float32)
    f_jax = jnet(mxj.nd.array(x)).asnumpy()
    f_port = tnet(torch.from_numpy(x)).numpy()
    jq.quantize_net(jnet, calib_data=[mxj.nd.array(b) for b in calib],
                    calib_mode="naive")
    tq.quantize_net(tnet, calib_data=[torch.from_numpy(b) for b in calib],
                    calib_mode="naive")
    return {"jnet": jnet, "tnet": tnet, "x": x, "f_jax": f_jax,
            "f_port": f_port, "q_jax": jnet(mxj.nd.array(x)).asnumpy(),
            "q_port": tnet(torch.from_numpy(x)).numpy()}


def test_resnet_same_layers_weights_and_thresholds(resnet):
    js, ts = _jax_state(resnet["jnet"]), convert.quantized_state(
        resnet["tnet"])
    # 16 convolutions (the 7x7 stem, 3 per bottleneck, 4 downsamples)
    # and the classifier
    assert len(js) == 18 and sorted(js) == sorted(ts)
    for path in js:
        np.testing.assert_array_equal(ts[path]["wq"], js[path]["wq"])
        np.testing.assert_array_equal(_bits(ts[path]["w_scale"]),
                                      _bits(js[path]["w_scale"]))
        assert ts[path]["wq"].dtype == np.int8
        assert abs(ts[path]["act_scale"] - js[path]["act_scale"]) \
            <= THRESHOLD_RTOL * js[path]["act_scale"], path
        assert (ts[path]["bias"] is None) == (js[path]["bias"] is None)
    assert isinstance(resnet["tnet"].features[0], tq._QuantizedConv2D)
    assert isinstance(resnet["tnet"].output, tq._QuantizedDense)


def test_resnet_int8_forward_matches_jax(resnet):
    f, q_jax = resnet["f_jax"], resnet["q_jax"]
    scale = np.abs(q_jax).max()
    assert scale > 0.1
    # each package's own calibration: within the float layers' spread
    assert np.abs(resnet["q_port"] - q_jax).max() <= 1e-5 * scale
    # the JAX suite's quantization bound against the float network
    assert np.abs(q_jax - f).max() <= 0.05 * np.abs(f).max()
    assert np.abs(resnet["f_port"] - f).max() <= 1e-5 * np.abs(f).max()
    tnet = resnet["tnet"]
    saved = convert.quantized_state(tnet)
    try:
        convert.load_quantized_state(tnet, _jax_state(resnet["jnet"]))
        before = (QM.LAUNCHES_MM, QM.LAUNCHES_MM_SCALED)
        out = tnet(torch.from_numpy(resnet["x"])).numpy()
        assert (QM.LAUNCHES_MM, QM.LAUNCHES_MM_SCALED) == before  # CPU
    finally:
        convert.load_quantized_state(tnet, saved)
    np.testing.assert_array_equal(_bits(out), _bits(q_jax))


def test_resnet_stem_codes_and_accumulator(resnet):
    """The stem sees the raw images: its codes and int32 sums are equal
    bit for bit to JAX's int8 convolution under either state."""
    import jax.numpy as jnp
    from jax import lax
    stem_j = resnet["jnet"].features[0]
    stem_t = resnet["tnet"].features[0]
    x = resnet["x"]
    xq_t = stem_t.quantize_input(torch.from_numpy(x))
    xq_j = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / stem_j._act_scale),
                               -127, 127).astype(jnp.int8))
    assert stem_t._act_scale == stem_j._act_scale
    np.testing.assert_array_equal(xq_t.numpy(), xq_j)
    cols, (n, ho, wo) = stem_t.columns(xq_t)
    assert cols.shape[1] == 160                     # K = 147 padded
    acc = QM.quantized_matmul(cols, stem_t._wmat)
    acc = acc.reshape(n, ho, wo, -1).permute(0, 3, 1, 2).numpy()
    ref = np.asarray(lax.conv_general_dilated(
        jnp.asarray(xq_t.numpy()), jnp.asarray(stem_t._wq.numpy()),
        (2, 2), ((3, 3), (3, 3)), dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.int32))
    np.testing.assert_array_equal(acc, ref)


def test_primitives_match_jax():
    x = np.linspace(-3, 3, 64).astype(np.float32)
    for rng in ((-3.0, 3.0), (-1.0, 2.5), (-0.75, 0.5)):
        q, mn, mx_ = tq.quantize(torch.from_numpy(x), *rng)
        jq_, jmn, jmx = jq.quantize(mxj.nd.array(x), *rng)
        np.testing.assert_array_equal(q.numpy(), jq_.asnumpy())
        np.testing.assert_array_equal(_bits(np.float32(mx_)),
                                      _bits(np.float32(jmx.asnumpy())))
        back = tq.dequantize(q, mn, mx_)
        jback = jq.dequantize(jq_, jmn, jmx)
        np.testing.assert_array_equal(_bits(back.numpy()),
                                      _bits(jback.asnumpy()))
    acc = np.random.RandomState(0).randint(-2 ** 20, 2 ** 20, 40) \
        .astype(np.int32)
    r = tq.requantize(torch.from_numpy(acc), -1e-3, 1e-3, -0.5, 0.5)
    jr = jq.requantize(mxj.nd.array(acc, dtype="int32"), -1e-3, 1e-3,
                       -0.5, 0.5)
    np.testing.assert_array_equal(r[0].numpy(), jr[0].asnumpy())


def test_optimal_threshold_matches_jax():
    a = np.random.RandomState(0).randn(100000)
    hist, edges = np.histogram(a, bins=1001, range=(-5, 5))
    t = tq._get_optimal_threshold(hist, edges)
    assert t == jq._get_optimal_threshold(hist, edges)
    assert 2.0 < t < 5.0
    assert tq._smooth_distribution(np.zeros(4)) is None


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_collector_matches_jax(mode):
    """Both modes on tensors and arrays, including a second batch whose
    range grows (the histogram then folds the first batch in)."""
    rng = np.random.RandomState(0)
    batches = [rng.randn(1000).astype(np.float32),
               (rng.randn(1000) * 3).astype(np.float32),
               (rng.randn(1000) * 0.5).astype(np.float32)]
    tc = tq.CalibrationCollector(mode=mode, num_bins=801)
    jc = jq.CalibrationCollector(mode=mode, num_bins=801)
    for i, b in enumerate(batches):
        tc.collect("l", torch.from_numpy(b) if i % 2 == 0 else b)
        jc.collect("l", b)
    assert tc.min_max == jc.min_max
    assert tc.threshold("l") == jc.threshold("l")
    assert tc.threshold("unseen") == jc.threshold("unseen") == 1.0
    if mode == "entropy":
        np.testing.assert_array_equal(tc.hists["l"][0], jc.hists["l"][0])
        assert tc.hists["l"][0].sum() == 3000
    with pytest.raises(AssertionError):
        tq.CalibrationCollector(mode="kl")


def _dense_nets():
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(32, activation="relu", in_units=16),
             jnn.Dense(10, in_units=32))
    jnet.initialize()
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    tnet = tnn.HybridSequential()
    tnet.add(tnn.Dense(32, activation="relu", in_units=16),
             tnn.Dense(10, in_units=32))
    tnet.initialize(ctx=mx.cpu())
    convert.load_numpy_params(tnet, arrays)
    return jnet, tnet


@pytest.mark.parametrize("calib_mode", ["naive", "entropy", "none"])
def test_dense_net_matches_jax(calib_mode, monkeypatch):
    # entropy mode with 401 bins in both packages (8001 take seconds each)
    for mod in (jq, tq):
        monkeypatch.setattr(mod, "CalibrationCollector", functools.partial(
            mod.CalibrationCollector, num_bins=401))
    jnet, tnet = _dense_nets()
    x = np.random.RandomState(1).randn(32, 16).astype(np.float32)
    ref = jnet(mxj.nd.array(x)).asnumpy()
    jq.quantize_net(jnet, calib_data=[mxj.nd.array(x)],
                    calib_mode=calib_mode)
    tq.quantize_net(tnet, calib_data=[(torch.from_numpy(x),)],
                    calib_mode=calib_mode)
    js, ts = _jax_state(jnet), convert.quantized_state(tnet)
    assert sorted(js) == sorted(ts) == ["0", "1"]
    # the first layer sees x itself; the second sees the float Dense
    # output, whose summation order differs between the packages
    assert ts["0"]["act_scale"] == js["0"]["act_scale"]
    assert abs(ts["1"]["act_scale"] - js["1"]["act_scale"]) \
        <= THRESHOLD_RTOL * js["1"]["act_scale"]
    for path in js:
        np.testing.assert_array_equal(ts[path]["wq"], js[path]["wq"])
    convert.load_quantized_state(tnet, js)
    out_j = jnet(mxj.nd.array(x)).asnumpy()
    out_t = tnet(torch.from_numpy(x)).numpy()
    assert out_t.shape == ref.shape
    np.testing.assert_array_equal(_bits(out_t), _bits(out_j))
    if calib_mode == "none":
        assert ts["0"]["act_scale"] == ts["1"]["act_scale"] == 1.0 / 127.0


@pytest.mark.parametrize("exclude", [["0"], ["1"], ["Dense"]])
def test_exclude_layers(exclude):
    jnet, tnet = _dense_nets()
    x = np.random.RandomState(2).randn(4, 16).astype(np.float32)
    jq.quantize_net(jnet, calib_data=[mxj.nd.array(x)],
                    exclude_layers=exclude)
    tq.quantize_net(tnet, calib_data=[torch.from_numpy(x)],
                    exclude_layers=exclude)
    assert sorted(_jax_state(jnet)) == sorted(convert.quantized_state(tnet))
    for i in range(2):
        assert isinstance(tnet[i], tnn.Dense) == isinstance(jnet[i],
                                                            jnn.Dense)


def test_nhwc_and_grouped_convs_stay_float():
    """quantize_net takes NCHW convolutions only: an NHWC conv stays float
    and only the Dense after it is quantized, as in JAX."""
    nets = []
    for nn_ in (jnn, tnn):
        net = nn_.HybridSequential()
        net.add(nn_.Conv2D(4, 3, layout="NHWC", in_channels=3),
                nn_.Dense(5, in_units=4 * 4 * 4))
        net.initialize(**({} if nn_ is jnn else {"ctx": mx.cpu()}))
        nets.append(net)
    jnet, tnet = nets
    x = np.random.RandomState(3).rand(2, 6, 6, 3).astype(np.float32)
    jq.quantize_net(jnet, calib_data=[mxj.nd.array(x)])
    tq.quantize_net(tnet, calib_data=[torch.from_numpy(x)])
    assert sorted(_jax_state(jnet)) == sorted(
        convert.quantized_state(tnet)) == ["1"]
    assert isinstance(tnet[0], tnn.Conv2D)
    net = tnn.HybridSequential()
    net.add(tnn.Conv2D(4, 3, groups=2, in_channels=4))
    net.initialize(ctx=mx.cpu())
    tq.quantize_net(net, calib_mode="none")
    assert isinstance(net[0], tnn.Conv2D)
    with pytest.raises(NotImplementedError):
        tq.calib_graph(None, {}, {}, None)


def test_converter_errors():
    _, tnet = _dense_nets()
    tq.quantize_net(tnet, calib_mode="none")
    state = convert.quantized_state(tnet)
    with pytest.raises(KeyError):
        convert.load_quantized_state(tnet, {"0": state["0"]})
    with pytest.raises(KeyError):
        convert.load_quantized_state(tnet, dict(state, extra=state["0"]))
    with pytest.raises(KeyError):
        convert.load_quantized_state(tnet, dict(state, **{"1": {
            k: v for k, v in state["1"].items() if k != "bias"}}))
    bad = {p: dict(e) for p, e in state.items()}
    bad["1"]["wq"] = np.zeros((10, 31), np.int8)
    with pytest.raises(ValueError):
        convert.load_quantized_state(tnet, bad)
    bad = {p: dict(e) for p, e in state.items()}
    bad["0"]["bias"] = None
    with pytest.raises(ValueError):
        convert.load_quantized_state(tnet, bad)
    # nothing was written by the failed loads
    after = convert.quantized_state(tnet)
    for p in state:
        np.testing.assert_array_equal(after[p]["wq"], state[p]["wq"])
    new = {p: dict(e, act_scale=0.5) for p, e in state.items()}
    convert.load_quantized_state(tnet, new)
    assert tnet[0]._act_scale == 0.5
    assert float(tnet[0]._scales[0]) == float(
        np.float32(0.5) * state["0"]["w_scale"][0])


# -- bf16: JAX's type promotion in the quantize steps -----------------------

def _f32_bits(a):
    """float32 bits of a bf16 (or float32) array of either package."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().view(np.int32)
    return np.asarray(a).astype(np.float32).view(np.int32)


@pytest.mark.parametrize("rng", [(-3.0, 3.0), (-1.0, 2.5), (-0.75, 0.5)])
def test_quantize_bf16_matches_jax(rng):
    """``127 / amax`` and the product in bf16, as the JAX package computes
    them for bf16 data."""
    x = (np.random.RandomState(4).randn(64, 256) * 1.5).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    q, mn, mx_ = tq.quantize(xt, *rng)
    jq_, jmn, jmx = jq.quantize(mxj.nd.array(xt.float().numpy())
                                .astype("bfloat16"), *rng)
    np.testing.assert_array_equal(q.numpy(), jq_.asnumpy())
    assert mx_.dtype == torch.bfloat16 and str(jmx.dtype) == "bfloat16"
    np.testing.assert_array_equal(_f32_bits(mx_), _f32_bits(jmx.asnumpy()))


def _dense_pair(dtype):
    """The same two-Dense network (32 -> 64 relu -> 10) in both packages,
    weights from numpy seed 5, cast to ``dtype``."""
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(64, in_units=32, activation="relu"),
             jnn.Dense(10, in_units=64))
    jnet.initialize()
    tnet = tnn.HybridSequential()
    tnet.add(tnn.Dense(64, in_units=32, activation="relu"),
             tnn.Dense(10, in_units=64))
    tnet.initialize(ctx=mx.cpu())
    jparams = jnet._collect_params_with_prefix()
    arrays = convert.random_numpy_params(
        {k: p.shape for k, p in jparams.items()}, seed=5)
    for k, p in jparams.items():
        p.set_data(mxj.nd.array(arrays[k]))
    convert.load_numpy_params(tnet, arrays)
    jnet.cast(dtype)
    tnet.cast(dtype)
    return jnet, tnet


def test_bf16_dense_quantize_net_matches_jax():
    """A bf16 network: int8 weights, bf16 weight scales, thresholds and
    the int8 logits equal to JAX's bit for bit (weight scales and input
    codes in bf16 with the Python activation scale rounded to bf16; the
    epilogue scales the bf16 product ``act_scale * w_scale``)."""
    jnet, tnet = _dense_pair("bfloat16")
    rs = np.random.RandomState(6)
    calib = [torch.from_numpy(rs.randn(8, 32).astype(np.float32))
             .to(torch.bfloat16) for _ in range(2)]
    x = torch.from_numpy(np.random.RandomState(8).randn(16, 32)
                         .astype(np.float32) * 2).to(torch.bfloat16)
    jx = [mxj.nd.array(b.float().numpy()).astype("bfloat16") for b in calib]
    jq.quantize_net(jnet, calib_data=jx, calib_mode="naive")
    tq.quantize_net(tnet, calib_data=calib, calib_mode="naive")
    for i in range(2):
        jl, tl = jnet[i], tnet[i]
        assert isinstance(tl, tq._QuantizedDense)
        np.testing.assert_array_equal(tl._wq.numpy(), np.asarray(jl._wq))
        assert tl._w_scale.dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32_bits(tl._w_scale),
                                      _f32_bits(jl._w_scale))
        assert tl._act_scale == jl._act_scale
    codes = jnp.clip(jnp.round(jnp.asarray(x.float().numpy())
                               .astype(jnp.bfloat16) / jnet[0]._act_scale),
                     -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(tnet[0].quantize_input(x).numpy(),
                                  np.asarray(codes))
    out = tnet(x)
    ref = jnet(mxj.nd.array(x.float().numpy()).astype("bfloat16"))
    assert str(ref.dtype) == str(out.dtype).replace("torch.", "")
    np.testing.assert_array_equal(_f32_bits(out), _f32_bits(ref.asnumpy()))


def test_quantize_net_state_has_no_autograd_history():
    """The int8 state is computed under no_grad: no tensor of it requires
    grad or keeps a graph back to the float weights."""
    _, tnet = _dense_pair("float32")
    calib = [torch.from_numpy(np.random.RandomState(9).randn(4, 32)
                              .astype(np.float32))]
    tq.quantize_net(tnet, calib_data=calib, calib_mode="naive")
    for layer in (tnet[0], tnet[1]):
        for name in ("_wq", "_w_scale", "_scales", "_wmat"):
            t = getattr(layer, name)
            assert not t.requires_grad and t.grad_fn is None, name

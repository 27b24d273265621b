"""The port's checkpoint path held against the JAX package's: ``nd.save``
and ``nd.load`` in the reference's binary ``.params`` format (the same
bytes for the same arrays; each package loads the other's files),
``Block.save_parameters``/``load_parameters`` carrying a narrow NHWC
ResNet between the packages with the same logits (within the ResNet bound
of tests/test_torch_resnet.py: 1e-4 of the largest logit), their
options, ``ParameterDict.save``/``load`` with prefixes, and a Trainer's
``save_states``/``load_states`` across a step.
"""
import os
import pickle
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

LOGIT_RTOL = 1e-4       # tests/test_torch_resnet.py's bound
NARROW = ([1, 1, 1, 1], [16, 16, 32, 64, 128])


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _mixed(nd, seed=0):
    """One dict of every dtype the format has a flag for, bf16 (stored as
    f32), a 0-dim array and an empty array."""
    rs = np.random.RandomState(seed)
    return {
        "f32": nd.array(rs.randn(3, 4).astype("float32")),
        "bf16": nd.array(rs.randn(5).astype("float32"), dtype="bfloat16"),
        "f16": nd.array(rs.randn(2, 2).astype("float16")),
        "i8": nd.array(rs.randint(-128, 127, (6,)).astype("int8")),
        "u8": nd.array(rs.randint(0, 255, (2, 3)).astype("uint8")),
        "i32": nd.array(rs.randint(-9, 9, (4,)).astype("int32")),
        "i64": nd.array(rs.randint(-9, 9, (3,)).astype("int64"),
                        dtype="int64"),
        "bool": nd.array(rs.rand(5) > 0.5),
        "scalar": nd.array(np.float32(2.5)),
        "empty": nd.zeros((0, 3)),
        "a/b.c": nd.array(rs.randn(2).astype("float32")),
    }


def _np(x):
    return x.asnumpy()


@pytest.mark.parametrize("payload", ["dict", "list", "single", "empty"])
def test_save_writes_the_jax_bytes(tmp_path, payload):
    def make(nd):
        d = _mixed(nd)
        if payload == "dict":
            return d
        if payload == "list":
            return [d[k] for k in ("f32", "bf16", "scalar", "i8", "bool")]
        if payload == "single":
            return d["f16"]
        return {}
    fp, fj = str(tmp_path / "port.params"), str(tmp_path / "jax.params")
    mx.nd.save(fp, make(mx.nd))
    mxj.nd.save(fj, make(mxj.nd))
    assert _bytes(fp) == _bytes(fj)


def _same_loaded(a, b):
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b)
        for k in b:
            _same_loaded(a[k], b[k])
        return
    if isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_loaded(x, y)
        return
    x, y = _np(a), _np(b)
    assert x.shape == y.shape and str(x.dtype) == str(y.dtype)
    assert np.array_equal(x, y)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_loads_the_others_file(tmp_path, writer):
    f = str(tmp_path / "x.params")
    (mx if writer == "port" else mxj).nd.save(f, _mixed(
        mx.nd if writer == "port" else mxj.nd))
    _same_loaded(mx.nd.load(f), mxj.nd.load(f))
    # a list comes back as a list, an empty save as {}
    (mx if writer == "port" else mxj).nd.save(f, [
        (mx if writer == "port" else mxj).nd.ones((2,))])
    _same_loaded(mx.nd.load(f), mxj.nd.load(f))
    assert isinstance(mx.nd.load(f), list)
    (mx if writer == "port" else mxj).nd.save(f, {})
    assert mx.nd.load(f) == {} == mxj.nd.load(f)


def test_record_layout_and_loaded_dtypes(tmp_path):
    f = str(tmp_path / "x.params")
    mx.nd.save(f, {"b": mx.nd.array([1.0, 2.0], dtype="bfloat16"),
                   "a": mx.nd.array(np.float32(3.0))})
    raw = _bytes(f)
    assert struct.unpack("<QQQ", raw[:24]) == (0x112, 0, 2)
    # names sorted: "a" (0-dim, a V3 record) first, then "b" (V2)
    assert struct.unpack("<I", raw[24:28])[0] == 0xF993faca
    loaded = mx.nd.load(f)
    assert str(loaded["b"].dtype) == "float32"      # bf16 stored as f32
    assert loaded["a"].shape == () and float(loaded["a"]) == 3.0
    assert loaded["b"].context == mx.cpu()
    with open(f, "rb") as fh:                       # file-like objects too
        _same_loaded(mx.nd.load(fh), loaded)


def test_truncated_file_raises_value_error(tmp_path):
    f = str(tmp_path / "x.params")
    mx.nd.save(f, _mixed(mx.nd))
    raw = _bytes(f)
    for cut in (8, 30, len(raw) // 2, len(raw) - 3):
        g = str(tmp_path / ("cut%d.params" % cut))
        with open(g, "wb") as fh:
            fh.write(raw[:cut])
        with pytest.raises(ValueError):
            mx.nd.load(g)
        with pytest.raises(ValueError):
            mxj.nd.load(g)
    bad = str(tmp_path / "bad.params")
    with open(bad, "wb") as fh:
        fh.write(b"\x00" * 32)
    with pytest.raises(ValueError):
        mx.nd.load(bad)


def test_early_pickle_snapshot_is_read(tmp_path):
    arrays = {"w": np.arange(6, dtype="float32").reshape(2, 3),
              "b": np.ones(3, "float32")}
    for kind, payload in (("dict", arrays), ("list", list(arrays.values())),
                          ("single", arrays["w"])):
        f = str(tmp_path / (kind + ".params"))
        with open(f, "wb") as fh:
            fh.write(b"MXTPU_ND1")
            pickle.dump((kind, payload), fh)
        _same_loaded(mx.nd.load(f), mxj.nd.load(f))


def test_interrupted_save_leaves_the_old_file(tmp_path, monkeypatch):
    f = str(tmp_path / "x.params")
    mx.nd.save(f, {"a": mx.nd.ones((2,))})
    before = _bytes(f)

    class Boom(Exception):
        pass

    def fail(*a, **k):
        raise Boom()
    monkeypatch.setattr(mx.nd, "_write_one", fail)
    with pytest.raises(Boom):
        mx.nd.save(f, {"a": mx.nd.zeros((3,))})
    assert _bytes(f) == before
    assert os.listdir(tmp_path) == ["x.params"]


# -- save_parameters / load_parameters between the packages --------------------

def _jax_resnet(x):
    net = jres.ResNetV1(jres.BasicBlockV1, *NARROW, classes=10,
                        thumbnail=True, layout="NHWC", fuse=False)
    net.initialize()
    net(mxj.nd.array(np.zeros_like(x)))
    return net


def _port_resnet():
    net = tres.ResNetV1(tres.BasicBlockV1, *NARROW, classes=10,
                        thumbnail=True, layout="NHWC", fuse=False)
    net.initialize(ctx=mx.cpu())
    return net


def _close_logits(got, want):
    scale = np.abs(want).max()
    assert scale > 0.1, scale
    assert np.abs(got - want).max() <= LOGIT_RTOL * scale


def test_resnet_saved_by_jax_loads_into_the_port(tmp_path):
    x = np.random.RandomState(7).rand(2, 3, 32, 32).astype("float32")
    jnet = _jax_resnet(x)
    arrays = convert.random_numpy_params(
        {k: p.shape for k, p in jnet._collect_params_with_prefix().items()},
        seed=3)
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(mxj.nd.array(arrays[k]))
    f = str(tmp_path / "jax.params")
    jnet.save_parameters(f)
    ref = jnet(mxj.nd.array(x)).asnumpy()
    net = _port_resnet()
    net.load_parameters(f, ctx=mx.cpu())       # deferred params take shape
    out = net(mx.nd.array(x))
    assert isinstance(out, mx.nd.NDArray) and out.shape == (2, 10)
    _close_logits(out.asnumpy(), ref)
    # the tensor path gives the same bits
    assert np.array_equal(net(torch.from_numpy(x)).numpy(), out.asnumpy())


def test_resnet_saved_by_the_port_loads_into_jax(tmp_path):
    x = np.random.RandomState(8).rand(2, 3, 32, 32).astype("float32")
    net = _port_resnet()
    net(torch.from_numpy(x))
    convert.load_numpy_params(net, convert.random_numpy_params(
        convert.param_shapes(net), seed=4))
    f = str(tmp_path / "port.params")
    net.save_parameters(f)
    jnet = _jax_resnet(x)
    jnet.load_parameters(f)
    _close_logits(net(mx.nd.array(x)).asnumpy(),
                  jnet(mxj.nd.array(x)).asnumpy())
    # and the JAX package writes back the same bytes
    g = str(tmp_path / "jax.params")
    jnet.save_parameters(g)
    assert _bytes(f) == _bytes(g)
    # a fresh port net reloads it bit for bit
    net2 = _port_resnet()
    net2.load_params(g, ctx=mx.cpu())
    assert np.array_equal(net2(mx.nd.array(x)).asnumpy(),
                          net(mx.nd.array(x)).asnumpy())


def _dense(pkg, prefix, shared=None):
    nn_ = tnn if pkg is mx else jnn
    net = nn_.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn_.Dense(4, in_units=3))
        net.add(nn_.Dense(2, in_units=4))
    if pkg is mx:
        net.initialize(ctx=mx.cpu())
    else:
        net.initialize()
    return net


def _set_weights(net, pkg, seed=0):
    rs = np.random.RandomState(seed)
    for k, p in sorted(net._collect_params_with_prefix().items()):
        p.set_data(pkg.nd.array(rs.randn(*p.shape).astype("float32")))


def test_load_parameters_options_match_jax(tmp_path):
    f = str(tmp_path / "d.params")
    for pkg in (mx, mxj):
        src = _dense(pkg, "src_")
        _set_weights(src, pkg)
        src.save_parameters(f)
        # extra keys: raise unless ignore_extra
        small = (tnn if pkg is mx else jnn).HybridSequential(prefix="small_")
        with small.name_scope():
            small.add((tnn if pkg is mx else jnn).Dense(4, in_units=3))
        if pkg is mx:
            small.initialize(ctx=mx.cpu())
        else:
            small.initialize()
        with pytest.raises(KeyError):
            small.load_parameters(f)
        small.load_parameters(f, ignore_extra=True)
        assert np.array_equal(_np(small[0].weight.data()),
                              _np(src[0].weight.data()))
        # missing keys: raise unless allow_missing
        small.save_parameters(f + ".small")
        nn_ = tnn if pkg is mx else jnn
        big = nn_.HybridSequential(prefix="big_")   # never initialized
        with big.name_scope():
            big.add(nn_.Dense(4, in_units=3))
            big.add(nn_.Dense(2, in_units=4))
        with pytest.raises(KeyError):
            big.load_parameters(f + ".small")
        big.load_parameters(f + ".small", allow_missing=True)
    # a checkpoint in f16 with cast_dtype and dtype_source="saved"
    res = []
    for pkg in (mx, mxj):
        src = _dense(pkg, "h_")
        _set_weights(src, pkg, seed=2)
        src.cast("float16")
        src.save_parameters(f)
        dst = _dense(pkg, "h2_")
        dst.load_parameters(f, cast_dtype=True, dtype_source="saved")
        assert str(dst[0].weight.data().dtype) == "float16"
        dst2 = _dense(pkg, "h3_")
        dst2.load_parameters(f)           # the current dtype wins
        assert str(dst2[0].weight.data().dtype) == "float32"
        res.append((dst[1].bias.data(), dst2[0].weight.data()))
    for a, b in zip(res[0], res[1]):
        _same_loaded(a, b)


def test_deduplicate_and_full_name_fallback(tmp_path):
    f = str(tmp_path / "d.params")
    for pkg in (mx, mxj):
        nn_ = tnn if pkg is mx else jnn
        net = nn_.HybridSequential(prefix="dd_")
        with net.name_scope():
            a = nn_.Dense(3, in_units=3)
            net.add(a)
            net.add(a)                  # one block, so one parameter set
        if pkg is mx:
            net.initialize(ctx=mx.cpu())
        else:
            net.initialize()
        net.save_parameters(f)
        full = pkg.nd.load(f)
        net.save_parameters(f + ".dedup", deduplicate=True)
        dedup = pkg.nd.load(f + ".dedup")
        assert sorted(full) == ["0.bias", "0.weight", "1.bias", "1.weight"]
        assert sorted(dedup) == ["0.bias", "0.weight"]
    # keys by full name, as an older ParameterDict.save wrote them
    for pkg in (mx, mxj):
        src = _dense(pkg, "fn_")
        _set_weights(src, pkg, seed=5)
        src.collect_params().save(f, strip_prefix="fn_")
        dst = _dense(pkg, "fn_")
        dst.load_parameters(f)
        for k, p in src._collect_params_with_prefix().items():
            assert np.array_equal(
                _np(p.data()), _np(dst._collect_params_with_prefix()[k]
                                   .data()))


def test_parameter_dict_save_and_load_with_prefixes(tmp_path):
    files = {}
    for pkg in (mx, mxj):
        net = _dense(pkg, "pd_")
        _set_weights(net, pkg, seed=6)
        f = str(tmp_path / ("%s.params" % pkg.__name__))
        net.collect_params().save(f, strip_prefix="pd_")
        files[pkg] = f
        other = _dense(pkg, "pd_")
        other.collect_params().load(f, restore_prefix="pd_")
        for k, p in net.collect_params().items():
            assert np.array_equal(_np(p.data()),
                                  _np(other.collect_params()[k].data()))
        with pytest.raises(KeyError):
            other.collect_params().load(f)      # no prefix: all missing
        other.collect_params().load(f, allow_missing=True,
                                    ignore_extra=True)
    assert _bytes(files[mx]) == _bytes(files[mxj])
    assert sorted(mx.nd.load(files[mx])) == sorted(mxj.nd.load(files[mxj]))


def test_trainer_states_round_trip_across_a_step(tmp_path):
    """Two nets from the same weights: one steps twice, the other steps,
    saves its parameters and states, and a fresh net and trainer load
    them and take the second step; the weights agree bit for bit."""
    x = mx.nd.array(np.random.RandomState(9).randn(5, 3).astype("float32"))
    y = mx.nd.array(np.array([0, 1, 1, 0, 1], "float32"))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def step(net, trainer):
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(5)

    def fresh():
        net = _dense(mx, "ts_")
        _set_weights(net, mx, seed=7)
        return net, mx.gluon.Trainer(net.collect_params(), "sgd",
                                     {"learning_rate": 0.1,
                                      "momentum": 0.9})
    a, ta = fresh()
    step(a, ta)
    step(a, ta)
    b, tb = fresh()
    step(b, tb)
    fp, fs = str(tmp_path / "b.params"), str(tmp_path / "b.states")
    b.save_parameters(fp)
    tb.save_states(fs)
    c, tc = fresh()
    c.load_parameters(fp)
    tc.load_states(fs)
    step(c, tc)
    for k, p in a._collect_params_with_prefix().items():
        assert np.array_equal(
            _np(p.data()), _np(c._collect_params_with_prefix()[k].data())), k

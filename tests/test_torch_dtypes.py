"""dtypes given as type objects (``np.float32``, ``float``, ``int``, ...)
in the port, against the JAX package on the CPU: ``base.canonical_dtype``
and the entry points that take a dtype from user code -- ``nd.array``,
``nd.zeros``, ``NDArray.astype``, ``Block.cast``, ``transforms.Cast`` and
``amp.init``. With 64-bit types off, as in the JAX package, ``float`` and
``np.float64`` hold float32 and ``int`` and ``np.int64`` int32.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.contrib.amp import amp as jamp_mod
from mxnet_tpu.gluon.data.vision import transforms as jT
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import canonical_dtype
from mxnet_tpu_torch.contrib import amp as tamp
from mxnet_tpu_torch.contrib.amp import amp as tamp_mod
from mxnet_tpu_torch.gluon.data.vision import transforms as tT

TYPES = [np.float32, np.float16, np.uint8, np.int32, np.int8, np.float64,
         np.int64, np.bool_, float, int, bool]


def _jax_held(dt):
    """The dtype a JAX-package array given ``dt`` holds."""
    return str(mxj.nd.zeros((1,), dtype=dt).dtype)


def _name(t):
    return str(t).replace("torch.", "")


@pytest.mark.parametrize("dt", TYPES, ids=lambda d: d.__name__)
def test_canonical_dtype_of_type_objects(dt):
    assert _name(canonical_dtype(dt)) == _jax_held(dt)


@pytest.mark.parametrize("dt", TYPES, ids=lambda d: d.__name__)
def test_nd_array_zeros_and_astype(dt):
    src = np.arange(6).reshape(2, 3)
    with mx.cpu():
        t_arr = mx.nd.array(src, dtype=dt)
        t_zero = mx.nd.zeros((2, 3), dtype=dt)
        t_cast = mx.nd.array(src.astype(np.float32)).astype(dt)
    j_arr = mxj.nd.array(src, dtype=dt)
    j_zero = mxj.nd.zeros((2, 3), dtype=dt)
    j_cast = mxj.nd.array(src.astype(np.float32)).astype(dt)
    for t, j in ((t_arr, j_arr), (t_zero, j_zero), (t_cast, j_cast)):
        assert _name(t._data.dtype) == str(j.dtype)
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


@pytest.mark.parametrize("dt", [np.float16, np.float32, float])
def test_block_cast(dt):
    with mx.cpu():
        net = mx.gluon.nn.Dense(3, in_units=2)
        net.initialize()
        net.cast(dt)
        assert _name(net.weight.dtype) == _jax_held(dt)
        assert _name(net.weight._tensor().dtype) == _jax_held(dt)
    jnet = mxj.gluon.nn.Dense(3, in_units=2)
    jnet.initialize()
    jnet.cast(dt)
    assert str(jnet.weight.data().dtype) == _jax_held(dt)


@pytest.mark.parametrize("dt", [np.float16, np.float32, np.uint8])
def test_transforms_cast(dt):
    img = np.random.RandomState(0).randint(0, 255, (4, 5, 3)).astype("u1")
    with mx.cpu():
        t = tT.Cast(dt)(mx.nd.array(img))
    j = jT.Cast(dt)(mxj.nd.array(img))
    assert _name(t._data.dtype) == str(j.dtype)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_amp_init_with_a_numpy_type():
    try:
        tamp.init(target_dtype=np.float16)
        jamp.init(target_dtype=np.float16)
        assert tamp_mod._target_dtype == torch.float16
        assert jamp_mod._target_dtype == "float16"
    finally:
        tamp._reset()
        jamp._reset()

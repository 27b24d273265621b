"""Inception V3 for the model zoo (counterpart of
mxnet_tpu/gluon/model_zoo/vision/inception.py): parallel towers
concatenated on the channel axis; 299x299 inputs."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from .resnet import no_pretrained

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    for channels, kernel_size, strides, padding in conv_settings:
        kwargs = {"channels": channels, "kernel_size": kernel_size}
        if strides is not None:
            kwargs["strides"] = strides
        if padding is not None:
            kwargs["padding"] = padding
        out.add(_make_basic_conv(**kwargs))
    return out


class _Concurrent(HybridBlock):
    """The branches on one input, their outputs concatenated on
    channels."""

    def __init__(self, branches, **kwargs):
        super().__init__(**kwargs)
        self.branches = branches
        for i, b in enumerate(branches):
            self.register_child(b, "branch%d" % i)
            self._params.update(b.collect_params())

    def hybrid_forward(self, F, x):
        return F.concat(*[b(x) for b in self.branches], dim=1)


def _make_A(pool_features, prefix):
    return _Concurrent([
        _make_branch(None, (64, 1, None, None)),
        _make_branch(None, (48, 1, None, None), (64, 5, None, 2)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, None, 1)),
        _make_branch("avg", (pool_features, 1, None, None)),
    ], prefix=prefix)


def _make_B(prefix):
    return _Concurrent([
        _make_branch(None, (384, 3, 2, None)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, 2, None)),
        _make_branch("max"),
    ], prefix=prefix)


def _make_C(channels_7x7, prefix):
    return _Concurrent([
        _make_branch(None, (192, 1, None, None)),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0))),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (192, (1, 7), None, (0, 3))),
        _make_branch("avg", (192, 1, None, None)),
    ], prefix=prefix)


def _make_D(prefix):
    return _Concurrent([
        _make_branch(None, (192, 1, None, None), (320, 3, 2, None)),
        _make_branch(None, (192, 1, None, None), (192, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0)), (192, 3, 2, None)),
        _make_branch("max"),
    ], prefix=prefix)


class _SplitConcat(HybridBlock):
    """An E unit's inner split: one stem feeding two convs, their outputs
    concatenated."""

    def __init__(self, stem, paths, **kwargs):
        super().__init__(**kwargs)
        self.stem = stem
        self.paths = paths
        if stem is not None:
            self.register_child(stem, "stem")
            self._params.update(stem.collect_params())
        for i, p in enumerate(paths):
            self.register_child(p, "path%d" % i)
            self._params.update(p.collect_params())

    def hybrid_forward(self, F, x):
        if self.stem is not None:
            x = self.stem(x)
        return F.concat(*[p(x) for p in self.paths], dim=1)


def _make_E(prefix):
    return _Concurrent([
        _make_branch(None, (320, 1, None, None)),
        _SplitConcat(_make_basic_conv(channels=384, kernel_size=1),
                     [_make_basic_conv(channels=384, kernel_size=(1, 3),
                                       padding=(0, 1)),
                      _make_basic_conv(channels=384, kernel_size=(3, 1),
                                       padding=(1, 0))]),
        _SplitConcat(
            _make_branch(None, (448, 1, None, None), (384, 3, None, 1)),
            [_make_basic_conv(channels=384, kernel_size=(1, 3),
                              padding=(0, 1)),
             _make_basic_conv(channels=384, kernel_size=(3, 1),
                              padding=(1, 0))]),
        _make_branch("avg", (192, 1, None, None)),
    ], prefix=prefix)


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            add = self.features.add
            add(_make_basic_conv(channels=32, kernel_size=3, strides=2))
            add(_make_basic_conv(channels=32, kernel_size=3))
            add(_make_basic_conv(channels=64, kernel_size=3, padding=1))
            add(nn.MaxPool2D(pool_size=3, strides=2))
            add(_make_basic_conv(channels=80, kernel_size=1))
            add(_make_basic_conv(channels=192, kernel_size=3))
            add(nn.MaxPool2D(pool_size=3, strides=2))
            add(_make_A(32, "A1_"))
            add(_make_A(64, "A2_"))
            add(_make_A(64, "A3_"))
            add(_make_B("B_"))
            add(_make_C(128, "C1_"))
            add(_make_C(160, "C2_"))
            add(_make_C(160, "C3_"))
            add(_make_C(192, "C4_"))
            add(_make_D("D_"))
            add(_make_E("E1_"))
            add(_make_E("E2_"))
            add(nn.AvgPool2D(pool_size=8))
            add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    if pretrained:
        no_pretrained()
    return Inception3(**kwargs)

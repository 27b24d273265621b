"""SqueezeNet 1.0 and 1.1 for the model zoo (counterpart of
mxnet_tpu/gluon/model_zoo/vision/squeezenet.py)."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from .resnet import no_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1))
    out.add(_FireExpand(expand1x1_channels, expand3x3_channels))
    return out


def _make_fire_conv(channels, kernel_size, padding=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel_size, padding=padding))
    out.add(nn.Activation("relu"))
    return out


class _FireExpand(HybridBlock):
    """Parallel 1x1 and 3x3 expand convs, concatenated on channels."""

    def __init__(self, e1, e3, **kwargs):
        super().__init__(**kwargs)
        self.p1 = _make_fire_conv(e1, 1)
        self.p3 = _make_fire_conv(e3, 3, padding=1)

    def hybrid_forward(self, F, x):
        return F.concat(self.p1(x), self.p3(x), dim=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        assert version in ("1.0", "1.1")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            add = self.features.add
            if version == "1.0":
                add(nn.Conv2D(96, kernel_size=7, strides=2))
                add(nn.Activation("relu"))
                add(nn.MaxPool2D(3, 2, ceil_mode=True))
                add(_make_fire(16, 64, 64))
                add(_make_fire(16, 64, 64))
                add(_make_fire(32, 128, 128))
                add(nn.MaxPool2D(3, 2, ceil_mode=True))
                add(_make_fire(32, 128, 128))
                add(_make_fire(48, 192, 192))
                add(_make_fire(48, 192, 192))
                add(_make_fire(64, 256, 256))
                add(nn.MaxPool2D(3, 2, ceil_mode=True))
                add(_make_fire(64, 256, 256))
            else:
                add(nn.Conv2D(64, kernel_size=3, strides=2))
                add(nn.Activation("relu"))
                add(nn.MaxPool2D(3, 2, ceil_mode=True))
                add(_make_fire(16, 64, 64))
                add(_make_fire(16, 64, 64))
                add(nn.MaxPool2D(3, 2, ceil_mode=True))
                add(_make_fire(32, 128, 128))
                add(_make_fire(32, 128, 128))
                add(nn.MaxPool2D(3, 2, ceil_mode=True))
                add(_make_fire(48, 192, 192))
                add(_make_fire(48, 192, 192))
                add(_make_fire(64, 256, 256))
                add(_make_fire(64, 256, 256))
            add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def squeezenet1_0(pretrained=False, ctx=None, root=None, **kwargs):
    if pretrained:
        no_pretrained()
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, ctx=None, root=None, **kwargs):
    if pretrained:
        no_pretrained()
    return SqueezeNet("1.1", **kwargs)

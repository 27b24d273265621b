"""Convolution and pooling layers (counterpart of
mxnet_tpu/gluon/nn/conv_layers.py): Conv2D, MaxPool2D, GlobalAvgPool2D."""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._groups = groups
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "layout": layout}
        self.weight = self.params.get(
            "weight", shape=self._weight_shape(in_channels),
            init=weight_initializer, allow_deferred_init=True)
        if use_bias:
            self.bias = self.params.get("bias", shape=(channels,),
                                        init=bias_initializer,
                                        allow_deferred_init=True)
        self.act = Activation(activation) if activation else None

    def _weight_shape(self, in_channels):
        # OIHW in every layout
        return (self._channels,
                in_channels // self._groups if in_channels else 0) \
            + tuple(self._kwargs["kernel"])

    def _shape_hint(self, x, *args):
        layout = self._kwargs["layout"]
        cin = x.shape[-1] if layout.endswith("C") else x.shape[1]
        hints = {self.weight: self._weight_shape(cin)}
        if "bias" in self._reg_params:
            hints[self.bias] = (self._channels,)
        return hints

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Convolution(x, weight, bias, no_bias=bias is None,
                            **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), _tup(strides, 2),
                         _tup(padding, 2), _tup(dilation, 2), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "pool_type": pool_type, "global_pool": global_pool,
            "layout": layout,
            "pooling_convention": "full" if ceil_mode else "valid"}

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 2),
                         _tup(strides, 2) if strides is not None else None,
                         _tup(padding, 2), ceil_mode, False, "max",
                         layout=layout, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), False, True, "avg",
                         layout=layout, **kwargs)

"""ResNet V1 and V2 for the model zoo (counterpart of
mxnet_tpu/gluon/model_zoo/vision/resnet.py).

``layout="NHWC"`` builds the channels-last variant: the public API still
takes NCHW batches (one boundary transpose) and weights stay OIHW, while
every conv, BatchNorm and pool runs channels-last. ``fuse=True`` (NHWC
only) routes each residual block's BN->ReLU->3x3-conv link through the
hand-written kernel of ``kernels/conv_fused.py``: the BatchNorm's running
statistics are folded into a per-channel scale and bias, and the kernel
applies them with the ReLU while loading its input. ``fuse="auto"`` does
so only where the 3x3 conv is at least 512 channels wide, the JAX
package's policy.

V2 is the pre-activation network (``BasicBlockV2``, ``BottleneckV2``,
``ResNetV2``): a BatchNorm without scale or shift on the image, then
BN -> ReLU -> conv units; it has no fused link. With ``layout="NHWC"``
every one of its BatchNorms is channels-last, so in training each takes
the fused BatchNorm kernels (``kernels/batchnorm_fused.py``), the one on
the image at C = 3 included.
"""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from ....base import MXNetError

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet", "resnet18_v1",
           "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
           "resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2",
           "resnet152_v2"]


def _bn_axis(layout):
    return -1 if layout == "NHWC" else 1


def _conv3x3(channels, stride, in_channels, layout="NCHW"):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, layout=layout)


# -- fused BN->ReLU->conv3x3 link (fuse=True, NHWC only) ---------------------
# Two private OpDefs kept out of the global registry, invoked through the F
# namespace's dispatch point like any op: the BatchNorm fold and the fused
# convolution (differentiable: its backward is the conv_fused backward
# kernels).
_BN_FOLD_OP = None
_FUSED_CONV_OP = None


def _fused_opdefs():
    global _BN_FOLD_OP, _FUSED_CONV_OP
    if _FUSED_CONV_OP is None:
        import torch
        from ....ops.registry import OpDef
        from ....ops.nn import batch_moments
        from ....kernels.conv_fused import fused_scale_relu_conv3x3

        def _bn_fold(y, gamma, beta, eps=1e-5):
            # batch_moments, the BatchNorm op's statistics, returned in y's
            # dtype (so rounded to bf16 for a bf16 net) before the fold
            mean, var = batch_moments(y, (0, 1, 2), axis=3)
            s = gamma.float() * torch.rsqrt(var.float() + eps)
            b = beta.float() - mean.float() * s
            return s, b, mean, var

        from ....remat import checkpoint_name

        def _fused_conv(x, s, b, w, relu=True):
            w_hwio = w.permute(2, 3, 1, 0)           # OIHW -> HWIO
            x = x.contiguous()
            # tagged like every other conv, so that a conv_outs remat
            # policy keeps it instead of launching the kernel again
            with checkpoint_name("conv_out"):
                return fused_scale_relu_conv3x3(x, s, b, w_hwio, relu=relu)

        _BN_FOLD_OP = OpDef("_fused_bn_fold", _bn_fold)
        _FUSED_CONV_OP = OpDef("_fused_scale_relu_conv3x3", _fused_conv)
    return _BN_FOLD_OP, _FUSED_CONV_OP


def _fused_producer_conv(bn, conv, y, F):
    """y -> conv3x3(relu(bn(y))) with the normalize/ReLU chain applied by
    the fused kernel. In training mode ``bn`` folds the batch statistics
    and moves its running statistics as the BatchNorm layer does;
    otherwise it folds its running statistics. On a ``meta`` y (shape
    inference) the parameters enter as meta tensors too."""
    from .... import autograd
    from ...block import report_aux_update
    from ....base import weak_scalar
    from ....ndarray.register import invoke

    fold_op, conv_op = _fused_opdefs()
    if bn.gamma._data is None:
        bn._infer_param_shapes(y)

    def tensor(p):
        return p._tensor().to("meta") if y.is_meta else p._tensor()
    gamma, beta = tensor(bn.gamma), tensor(bn.beta)
    if not bn._scale:
        # BatchNorm's fix_gamma (= not scale) replaces gamma with ones
        gamma = F.ones_like(gamma)
    if autograd.is_training() and not bn._use_global_stats:
        s, b, mean, var = invoke(fold_op, (y, gamma, beta),
                                 {"eps": bn._eps})
        m = bn._momentum
        for param, stat in ((bn.running_mean, mean), (bn.running_var, var)):
            run = param._tensor()
            report_aux_update(param, weak_scalar(m, run.dtype) * run
                              + weak_scalar(1 - m, run.dtype)
                              * stat.detach().to(run.dtype))
    else:
        rm = F.cast(tensor(bn.running_mean), "float32")
        rv = F.cast(tensor(bn.running_var), "float32")
        s = F.cast(gamma, "float32") * F.rsqrt(rv + bn._eps)
        b = F.cast(beta, "float32") - rm * s
    return invoke(conv_op, (y, s, b, tensor(conv.weight)), {"relu": True})


def _is_nd(F):
    """Whether ``F`` is the tensor namespace (not a symbolic trace's): the
    fused link has no symbol op."""
    return getattr(F, "__name__", "").endswith("ndarray")


class BasicBlockV1(HybridBlock):
    """Two 3x3 convs, post-activation residual unit. ``fuse=True`` routes
    the BN->ReLU->second-conv link through the fused kernel."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", fuse=False, **kwargs):
        super().__init__(**kwargs)
        self._fuse = fuse
        ax = _bn_axis(layout)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels, layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, layout))
        self.body.add(nn.BatchNorm(axis=ax))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout))
            self.downsample.add(nn.BatchNorm(axis=ax))
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        if self._fuse and _is_nd(F):
            y = self.body[0](x)
            y = _fused_producer_conv(self.body[1], self.body[3], y, F)
            x = self.body[4](y)
        else:
            x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class BottleneckV1(HybridBlock):
    """1x1 -> 3x3 -> 1x1 bottleneck, post-activation. The stride sits on
    the first 1x1, so the 3x3 is stride 1 -- the fused kernel's domain."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", fuse=False, **kwargs):
        super().__init__(**kwargs)
        self._fuse = fuse
        ax = _bn_axis(layout)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1, strides=stride,
                                use_bias=False, layout=layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4, layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                use_bias=False, layout=layout))
        self.body.add(nn.BatchNorm(axis=ax))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout))
            self.downsample.add(nn.BatchNorm(axis=ax))
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        if self._fuse and _is_nd(F):
            y = self.body[0](x)                       # 1x1 (stride)
            y = _fused_producer_conv(self.body[1], self.body[3], y, F)
            for i in (4, 5, 6, 7):                    # bn, relu, 1x1, bn
                y = self.body[i](y)
            x = y
        else:
            x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class ResNetV1(HybridBlock):
    """Post-activation ResNet. ``layout="NHWC"`` runs channels-last behind
    an NCHW public input; ``fuse`` is True, False or "auto"."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 layout="NCHW", fuse=False, **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        if fuse and layout != "NHWC":
            raise ValueError("fuse=True requires layout='NHWC' (the fused "
                             "conv kernel is channels-last)")
        self._layout = layout
        ax = _bn_axis(layout)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, layout))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False, layout=layout))
                self.features.add(nn.BatchNorm(axis=ax))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=channels[i], layout=layout, fuse=fuse))
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.output = nn.Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0, layout="NCHW", fuse=False):
        # fuse="auto": the fused kernel only where the 3x3 is >= 512 wide
        # (channels//4 in bottlenecks, channels in basic blocks)
        width3x3 = channels // 4 if block is BottleneckV1 else channels
        block_fuse = bool(fuse) if fuse != "auto" else width3x3 >= 512
        layer = nn.HybridSequential(prefix="stage%d_" % stage_index)
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, layout=layout,
                            fuse=block_fuse, prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                layout=layout, fuse=block_fuse, prefix=""))
        return layer

    def hybrid_forward(self, F, x):
        if self._layout == "NHWC":
            x = F.transpose(x, axes=(0, 2, 3, 1))
        x = self.features(x)
        return self.output(x)


class BasicBlockV2(HybridBlock):
    """Two 3x3 convs, pre-activation residual unit."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = _conv3x3(channels, 1, channels, layout)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.Activation(self.bn2(x), act_type="relu")
        return self.conv2(x) + residual


class BottleneckV2(HybridBlock):
    """1x1 -> 3x3 -> 1x1 pre-activation bottleneck; the stride sits on the
    3x3."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                               use_bias=False, layout=layout)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4, layout)
        self.bn3 = nn.BatchNorm(axis=ax)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False, layout=layout)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.Activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        x = F.Activation(self.bn3(x), act_type="relu")
        return self.conv3(x) + residual


class ResNetV2(HybridBlock):
    """Pre-activation ResNet; ``layout="NHWC"`` as in ResNetV1."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        self._layout = layout
        ax = _bn_axis(layout)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False,
                                           axis=ax))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, layout))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False, layout=layout))
                self.features.add(nn.BatchNorm(axis=ax))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=in_channels, layout=layout))
                in_channels = channels[i + 1]
            self.features.add(nn.BatchNorm(axis=ax))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels)

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0, layout="NCHW"):
        layer = nn.HybridSequential(prefix="stage%d_" % stage_index)
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, layout=layout,
                            prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                layout=layout, prefix=""))
        return layer

    def hybrid_forward(self, F, x):
        if self._layout == "NHWC":
            x = F.transpose(x, axes=(0, 2, 3, 1))
        x = self.features(x)
        return self.output(x)


# num_layers -> (block type, per-stage depths, channels)
resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]
_NETS = dict(enumerate(resnet_net_versions, 1))
_BLOCKS = dict(enumerate(resnet_block_versions, 1))


def no_pretrained():
    """What every zoo constructor raises for ``pretrained=True``."""
    raise MXNetError("pretrained weights are not available offline; "
                     "load weights with convert.load_numpy_params")


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """Build a ResNet V1 or V2 (random weights; no pretrained
    downloads)."""
    if pretrained:
        no_pretrained()
    if version not in _NETS:
        raise ValueError("invalid resnet version %r; options: 1, 2"
                         % (version,))
    if num_layers not in resnet_spec:
        raise ValueError("invalid resnet depth %d; options: %s"
                         % (num_layers, sorted(resnet_spec)))
    block_type, layers, channels = resnet_spec[num_layers]
    return _NETS[version](_BLOCKS[version][block_type], layers, channels,
                          **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)

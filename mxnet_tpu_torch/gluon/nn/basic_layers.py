"""Core Gluon layers (counterpart of mxnet_tpu/gluon/nn/basic_layers.py):
Sequential, HybridSequential, Dense, Dropout, BatchNorm, InstanceNorm,
LayerNorm, GroupNorm, Embedding, Flatten, Lambda, HybridLambda,
Activation, LeakyReLU, PReLU, ELU, SELU, Swish and GELU."""
from __future__ import annotations

import math

from ... import autograd
from ... import remat
from ...base import weak_scalar
from ..block import Block, HybridBlock, report_aux_update

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "BatchNorm", "InstanceNorm", "LayerNorm", "GroupNorm",
           "Embedding", "Flatten", "Lambda", "HybridLambda", "Activation",
           "LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU"]


class Sequential(Block):
    """Children run in the order they were added; child i is named "i"."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block, str(len(self._modules)))
            self._params.update(block.collect_params())

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def __iter__(self):
        return iter(self._modules.values())


class HybridSequential(HybridBlock):
    """Children run in the order they were added; child i is named "i".
    Under a remat policy (``remat.segmenting()``) each composite child and
    each run of consecutive leaf children runs as one checkpoint region
    (``remat.py`` says why)."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block, str(len(self._modules)))
            self._params.update(block.collect_params())

    def forward(self, x, *args):
        if remat.segmenting():
            return self._forward_regions(x)
        for block in self._modules.values():
            x = block(x)
        return x

    def _forward_regions(self, x):
        run = []

        def flush(x):
            if run:
                blocks = tuple(run)
                run.clear()
                x = remat.region(lambda t: _chain(blocks, t), x)
            return x
        for block in self._modules.values():
            if isinstance(block, HybridSequential):
                x = block(flush(x))
            elif block._child_blocks():
                x = remat.region(block, flush(x))
            else:
                run.append(block)
        return flush(x)

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def __iter__(self):
        return iter(self._modules.values())


def _chain(blocks, x):
    for block in blocks:
        x = block(x)
    return x


class Dense(HybridBlock):
    """Fully-connected layer."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._flatten = flatten
        self.act = Activation(activation) if activation else None
        self.weight = self.params.get(
            "weight", shape=(units, in_units), dtype=dtype,
            init=weight_initializer, allow_deferred_init=True)
        if use_bias:
            self.bias = self.params.get(
                "bias", shape=(units,), dtype=dtype, init=bias_initializer,
                allow_deferred_init=True)

    def _shape_hint(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        hints = {self.weight: (self._units, in_units)}
        if "bias" in self._reg_params:
            hints[self.bias] = (self._units,)
        return hints

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self.act is not None:
            out = self.act(out)
        return out


class Dropout(HybridBlock):
    """Zeroes each entry (each slice along ``axes``) with probability
    ``rate`` in training and scales the rest by 1 / (1 - rate); the mask
    comes from the port's generator of the input's device."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate <= 0:
            return x
        return F.Dropout(x, p=self._rate, axes=self._axes)


class BatchNorm(HybridBlock):
    """Batch normalization; the running statistics are buffers. In training
    mode (and not ``use_global_stats``) it normalizes with the batch
    statistics and moves the running ones to ``m*running + (1-m)*batch``
    in the running statistics' dtype, outside the graph."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._momentum = momentum
        self._eps = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.gamma = self.params.get(
            "gamma", shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True, differentiable=scale)
        self.beta = self.params.get(
            "beta", shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True, differentiable=center)
        self.running_mean = self.params.get(
            "running_mean", shape=(in_channels,),
            init=running_mean_initializer, allow_deferred_init=True,
            differentiable=False)
        self.running_var = self.params.get(
            "running_var", shape=(in_channels,),
            init=running_variance_initializer, allow_deferred_init=True,
            differentiable=False)

    def _shape_hint(self, x, *args):
        c = x.shape[self._axis]
        return {self.gamma: (c,), self.beta: (c,),
                self.running_mean: (c,), self.running_var: (c,)}

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        out, mean, var = F.BatchNorm(
            x, gamma, beta, running_mean, running_var, eps=self._eps,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis)
        if autograd.is_training() and not self._use_global_stats:
            m = self._momentum
            for param, run, stat in ((self.running_mean, running_mean, mean),
                                     (self.running_var, running_var, var)):
                report_aux_update(param, weak_scalar(m, run.dtype) * run
                                  + weak_scalar(1 - m, run.dtype)
                                  * stat.detach().to(run.dtype))
        return out


class Activation(HybridBlock):
    def __init__(self, activation, prefix=None, params=None):
        # _act_type must exist before Block.__init__ calls _alias()
        self._act_type = activation
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return str(self._act_type)

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.flatten(x)


class _AffineNorm(HybridBlock):
    """A normalization layer with a per-channel gamma and beta over axis
    ``axis`` of its input."""

    def __init__(self, axis, epsilon, center, scale, beta_initializer,
                 gamma_initializer, in_channels, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._eps = epsilon
        self.gamma = self.params.get(
            "gamma", shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True, differentiable=scale)
        self.beta = self.params.get(
            "beta", shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True, differentiable=center)

    def _shape_hint(self, x, *args):
        c = x.shape[self._axis]
        return {self.gamma: (c,), self.beta: (c,)}


class InstanceNorm(_AffineNorm):
    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(1, epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix, params)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._eps)


class LayerNorm(_AffineNorm):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(axis, epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix, params)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._eps)


class GroupNorm(_AffineNorm):
    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        # gamma and beta train whatever center and scale say, as in the
        # JAX package
        super().__init__(1, epsilon, True, True, beta_initializer,
                         gamma_initializer, in_channels, prefix, params)
        self._num_groups = num_groups

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._eps)


class Embedding(HybridBlock):
    """Rows of a (input_dim, output_dim) weight looked up by index."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim), dtype=dtype,
            init=weight_initializer, allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class Lambda(Block):
    """A block around a function, or the name of an ``mx.nd`` one."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd
            function = getattr(nd, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """A block around a function of its inputs, or the name of an ``F``
    op (the JAX package's form: the function is not passed ``F``)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._fname, self._func = function, None
        else:
            self._fname, self._func = None, function

    def hybrid_forward(self, F, *args):
        fn = getattr(F, self._fname) if self._fname else self._func
        return fn(*args)


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope (one value, initialized 0.25)."""

    def __init__(self, alpha_initializer=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        from ... import initializer
        self.alpha = self.params.get(
            "alpha", shape=(1,),
            init=alpha_initializer or initializer.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)

"""Core Gluon layers (counterpart of mxnet_tpu/gluon/nn/basic_layers.py):
HybridSequential, Dense, BatchNorm, Activation, Flatten."""
from __future__ import annotations

import math

from ... import autograd
from ... import remat
from ...base import weak_scalar
from ..block import HybridBlock, report_aux_update

__all__ = ["HybridSequential", "Dense", "BatchNorm", "Activation",
           "Flatten"]


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

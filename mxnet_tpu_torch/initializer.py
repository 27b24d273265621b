"""Weight initializers (counterpart of mxnet_tpu/initializer.py): Uniform,
the default, Normal (the VGG zoo's), Constant (PReLU's slope), plus the
Zero/One fills BatchNorm uses. Draws come from the
port's explicit host ``torch.Generator`` (``random.generator()``) and are
moved to the parameter's device afterwards."""
from __future__ import annotations

import torch

from .random import generator as _generator

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "get", "fill"]


class Initializer:
    """Base class. Subclasses override ``_init_weight``; ``dispatch``
    picks the fill by parameter-name suffix as MXNet does."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, arr):
        self.dispatch(name, arr)

    def dispatch(self, name, arr):
        """Fill the host tensor ``arr`` in place by ``name``'s suffix."""
        name = name.lower()
        if name.endswith("bias") or name.endswith("beta") \
                or name.endswith("running_mean") \
                or name.endswith("moving_mean"):
            arr.zero_()
        elif name.endswith("gamma") or name.endswith("running_var") \
                or name.endswith("moving_var"):
            arr.fill_(1.0)
        else:
            self._init_weight(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, self._kwargs)


class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr.zero_()


class One(Initializer):
    def _init_weight(self, _, arr):
        arr.fill_(1.0)


class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr.fill_(float(self.value))


class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr.uniform_(-self.scale, self.scale, generator=_generator())


class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr.normal_(0.0, self.sigma, generator=_generator())


_BY_NAME = {"zero": Zero, "zeros": Zero, "one": One, "ones": One,
            "constant": Constant, "uniform": Uniform, "normal": Normal}


def get(init):
    """An Initializer from an instance or a registry name."""
    if isinstance(init, Initializer):
        return init
    try:
        return _BY_NAME[str(init).lower()]()
    except KeyError:
        raise ValueError("initializer %r is not ported" % (init,)) from None


def fill(init, name, shape, dtype, device, specific=False):
    """A new tensor of ``shape`` filled on the host by ``init`` (name
    dispatch unless ``specific``) and placed on ``device`` as ``dtype``."""
    host = torch.empty(shape, dtype=torch.float32)
    if specific:
        init._init_weight(name, host)
    else:
        init.dispatch(name, host)
    return host.to(device=device, dtype=dtype)


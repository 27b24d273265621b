"""Weight initializers (counterpart of mxnet_tpu/initializer.py): every
class the JAX package registers (Zero, One, Constant, Uniform, Normal,
Orthogonal, Xavier, MSRAPrelu, Bilinear, LSTMBias, FusedRNN), ``Mixed``,
``InitDesc``, the registry (``register``, ``get``, ``create``) and
``Initializer.dumps``.

Fills run on a host tensor before the parameter moves to its device. Draws
come from the port's explicit host ``torch.Generator``
(``random.generator()``), so a random initializer agrees with the JAX
package's numpy draws by law, not bit for bit; the deterministic ones
(Zero, One, Constant, Bilinear, LSTMBias, FusedRNN's bias rows) agree
exactly. Conv weights are OIHW in both packages in every layout, so
Xavier's fans agree.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

from .random import generator as _generator

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "FusedRNN", "Mixed", "InitDesc", "get", "register", "create",
           "fill"]

_REG = {}
# the reference registers plural aliases ("zeros", "ones")
_ALIASES = {"zeros": "zero", "ones": "one"}


def register(klass):
    """Register an Initializer class under its lowercased name."""
    _REG[klass.__name__.lower()] = klass
    return klass


def _lookup(name):
    key = _ALIASES.get(name.lower(), name.lower())
    try:
        return _REG[key]
    except KeyError:
        raise KeyError("initializer %r not registered. Known: %s"
                       % (name, sorted(_REG))) from None


def get(init):
    """An Initializer from an instance (``Mixed`` too) or a registry
    name."""
    if isinstance(init, (Initializer, Mixed)):
        return init
    return _lookup(str(init))()


def create(spec):
    """An Initializer from a ``dumps()`` JSON spec, a registry name or an
    instance."""
    if isinstance(spec, (Initializer, Mixed)):
        return spec
    if isinstance(spec, str) and spec.startswith("["):
        klass, kwargs = json.loads(spec)
        return _lookup(klass)(**kwargs)
    return get(spec)


class InitDesc(str):
    """A parameter name with attributes: an ``__init__`` attribute (a
    ``dumps()`` spec or a name) overrides the global initializer."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


def _host_view(arr):
    """(tensor to fill in place, write-back or None) for a tensor, a numpy
    array or an NDArray."""
    from .ndarray.ndarray import NDArray
    if isinstance(arr, NDArray):
        host = arr._data.detach().to("cpu", copy=True)

        def back():
            arr._assign(host.to(device=arr._data.device,
                                dtype=arr._data.dtype))
        return host, back
    if isinstance(arr, np.ndarray):
        return torch.from_numpy(arr), None
    return arr, None


class Initializer:
    """Base class. Subclasses override ``_init_weight``;
    ``_init_weight_dispatch`` picks the fill by parameter-name suffix as
    MXNet does."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, desc, arr):
        """Fill ``arr`` (a tensor, numpy array or NDArray) in place for
        parameter ``desc``; an ``__init__`` attribute of an ``InitDesc``
        runs that initializer's ``_init_weight`` instead."""
        host, back = _host_view(arr)
        override = (getattr(desc, "attrs", None) or {}).get("__init__")
        if override:
            create(override)._init_weight(str(desc), host)
        else:
            self._init_weight_dispatch(str(desc), host)
        if back is not None:
            back()

    def _init_weight_dispatch(self, name, arr):
        name = name.lower()
        if name.endswith("bias"):
            self._init_bias(name, arr)
        elif name.endswith("gamma"):
            self._init_gamma(name, arr)
        elif name.endswith("beta"):
            self._init_beta(name, arr)
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            self._init_zero(name, arr)
        elif name.endswith("running_var") or name.endswith("moving_var"):
            self._init_one(name, arr)
        elif name.endswith("moving_inv_var") or name.endswith("moving_avg"):
            self._init_zero(name, arr)
        else:
            self._init_weight(name, arr)

    def _init_bias(self, _, arr):
        arr.zero_()

    def _init_gamma(self, _, arr):
        arr.fill_(1.0)

    def _init_beta(self, _, arr):
        arr.zero_()

    def _init_zero(self, _, arr):
        arr.zero_()

    def _init_one(self, _, arr):
        arr.fill_(1.0)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def dumps(self):
        """A JSON spec that ``create()`` turns back into this
        initializer."""
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, self._kwargs)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr.zero_()


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr.fill_(1.0)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        if np.isscalar(self.value):
            arr.fill_(self.value)
        else:
            arr.copy_(torch.as_tensor(np.asarray(self.value)))


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr.uniform_(-self.scale, self.scale, generator=_generator())


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr.normal_(0.0, self.sigma, generator=_generator())


@register
class Orthogonal(Initializer):
    """``scale`` times the orthonormal factor of an SVD of a uniform or
    normal draw: rows orthonormal where nout <= nin, columns otherwise."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        tmp = torch.empty((nout, nin), dtype=torch.float64)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=_generator())
        else:
            tmp.normal_(0.0, 1.0, generator=_generator())
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr.copy_((self.scale * q).reshape(arr.shape))


@register
class Xavier(Initializer):
    """Uniform in [-s, s] or normal with sigma s, s = sqrt(magnitude /
    factor), the factor the fan in, the fan out or their mean."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, _, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError("Xavier requires ndim >= 2")
        hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr.uniform_(-scale, scale, generator=_generator())
        else:
            arr.normal_(0.0, scale, generator=_generator())


@register
class MSRAPrelu(Xavier):
    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel over the last two axes."""

    def _init_weight(self, _, arr):
        shape = arr.shape
        i = np.arange(arr.numel())
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        arr.copy_(torch.from_numpy(weight.reshape(shape)))


@register
class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, _, arr):
        arr.zero_()
        num_hidden = arr.shape[0] // 4
        arr[num_hidden:2 * num_hidden] = self.forget_bias


# Gates per cell of the fused RNN op's modes, and the layer-0 input size
# of a packed parameter vector (the JAX package's ops/nn.py; the RNN op
# itself is not ported yet).
_RNN_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "gru": 3, "lstm": 4}


def _rnn_packed_input_size(total, mode, state_size, num_layers, ndir):
    g = _RNN_GATES[mode]
    h = state_size
    return total // ndir // g // h - (num_layers - 1) * (h + ndir * h + 2) \
        - h - 2


@register
class FusedRNN(Initializer):
    """A packed fused-RNN parameter vector: the inner initializer on each
    per-gate weight block (weights layer-major, direction inner, then the
    biases), LSTM forget-gate bias rows ``forget_bias``."""

    def __init__(self, init=None, num_hidden=None, num_layers=None,
                 mode="lstm", bidirectional=False, forget_bias=1.0):
        init_spec = init.dumps() if isinstance(init, Initializer) else init
        super().__init__(init=init_spec, num_hidden=num_hidden,
                         num_layers=num_layers, mode=mode,
                         bidirectional=bidirectional, forget_bias=forget_bias)
        self._init = create(init_spec) if init_spec else None
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._ndir = 2 if bidirectional else 1
        self._forget_bias = forget_bias

    def _init_weight(self, name, arr):
        g = _RNN_GATES[self._mode]
        h = self._num_hidden
        nd = self._ndir
        inner = self._init or Uniform(0.07)
        li = _rnn_packed_input_size(arr.numel(), self._mode, h,
                                    self._num_layers, nd)
        off = 0
        for layer in range(self._num_layers):
            isz = li if layer == 0 else h * nd
            for _ in range(nd):
                for cols in (isz, h):   # i2h weight, then h2h weight
                    for _ in range(g):
                        blk = arr[off:off + h * cols].view(h, cols)
                        inner._init_weight(name, blk)
                        off += h * cols
        for layer in range(self._num_layers):
            for _ in range(nd):
                for _ in range(2):      # i2h bias, then h2h bias
                    for j in range(g):
                        arr[off:off + h] = self._forget_bias \
                            if (self._mode == "lstm" and j == 1) else 0.0
                        off += h
        if off != arr.numel():
            raise ValueError("packed fused-RNN parameter size mismatch")


class Mixed:
    """Parameter-name patterns -> initializers: the first pattern that
    matches a name picks its initializer."""

    def __init__(self, patterns, initializers):
        self.map = [(re.compile(p), i) for p, i in zip(patterns, initializers)]

    def _match(self, name):
        for regex, init in self.map:
            if regex.search(str(name)):
                return init
        raise ValueError("no initializer matches %r" % name)

    def __call__(self, name, arr):
        self._match(name)(name, arr)

    def _init_weight_dispatch(self, name, arr):
        self._match(name)._init_weight_dispatch(name, arr)


def fill(init, name, shape, dtype, device, specific=False):
    """A new tensor of ``shape`` filled on the host by ``init`` and placed
    on ``device`` as ``dtype``. A parameter's own initializer
    (``specific``) runs its ``_init_weight`` (a ``Mixed`` its ``__call__``)
    and skips the name dispatch, as in the JAX package. Floating
    parameters are filled in float32, others in their own dtype."""
    host = torch.zeros(shape, dtype=torch.float32 if dtype.is_floating_point
                       else dtype)
    if not specific:
        init._init_weight_dispatch(name, host)
    elif hasattr(init, "_init_weight"):
        init._init_weight(name, host)
    else:
        init(name, host)
    return host.to(device=device, dtype=dtype)

"""Carry weights into a port network.

``load_numpy_params(net, arrays)`` takes numpy arrays keyed by the
structural names of ``_collect_params_with_prefix()``
("features.5.0.body.3.weight", "...running_var"): the same keys the JAX
package's blocks produce for the same architecture, so a dict read off a
JAX network loads here unchanged. ``random_numpy_params`` draws such a
dict from a seed for tests and smoke runs.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["load_numpy_params", "param_shapes", "random_numpy_params"]


def param_shapes(net):
    """{structural key: shape} of ``net``'s parameters (known dims; a
    deferred parameter reports 0 for dims the first forward decides)."""
    return {k: tuple(p.shape) for k, p in
            net._collect_params_with_prefix().items()}


def load_numpy_params(net, arrays):
    """Write ``arrays`` into ``net``'s parameters and running statistics.
    Raises KeyError on a missing or extra key and ValueError on a shape
    that disagrees with a known dim; nothing is written then."""
    params = net._collect_params_with_prefix()
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise KeyError("load_numpy_params: missing keys %s, extra keys %s"
                       % (missing, extra))
    for key, p in params.items():
        a = np.asarray(arrays[key])
        if p.shape is not None and (
                len(p.shape) != a.ndim
                or any(s > 0 and s != d for s, d in zip(p.shape, a.shape))):
            raise ValueError("load_numpy_params: %s has shape %s, the "
                             "network wants %s" % (key, a.shape, p.shape))
    for key, p in params.items():
        p.set_data(np.asarray(arrays[key]))


def random_numpy_params(shapes, seed=0):
    """Float32 arrays for ``shapes`` ({key: shape}) with activations that
    stay O(1) through a deep ResNet: conv and dense weights He-scaled
    (std sqrt(2/fan_in)), BatchNorm gamma in [0.5, 1), beta ~ N(0, 0.1),
    running_mean ~ N(0, 0.1), running_var in [0.5, 2], biases ~ N(0,
    0.1). The BatchNorm that closes a residual body ("body.<last>")
    gets gamma in [0.1, 0.3) so the residual sum does not double the
    activation scale block after block."""
    rs = np.random.RandomState(seed)
    last_bn = {}
    for key in shapes:
        head, _, leaf = key.rpartition(".")
        if leaf == "gamma" and ".body." in key:
            body, _, idx = head.rpartition(".")
            last_bn[body] = max(last_bn.get(body, -1), int(idx))
    out = {}
    for key in sorted(shapes):
        shape = tuple(shapes[key])
        head, _, leaf = key.rpartition(".")
        if leaf == "weight":
            fan_in = math.prod(shape[1:])
            a = rs.randn(*shape) * math.sqrt(2.0 / fan_in)
        elif leaf == "gamma":
            body, _, idx = head.rpartition(".")
            closes = body in last_bn and int(idx) == last_bn[body]
            a = rs.uniform(0.1, 0.3, shape) if closes \
                else rs.uniform(0.5, 1.0, shape)
        elif leaf == "running_var":
            a = rs.uniform(0.5, 2.0, shape)
        else:   # beta, running_mean, bias
            a = rs.randn(*shape) * 0.1
        out[key] = a.astype(np.float32)
    return out

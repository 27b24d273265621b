"""Carry weights into a port network.

``load_numpy_params(net, arrays)`` takes numpy arrays keyed by the
structural names of ``_collect_params_with_prefix()``
("features.5.0.body.3.weight", "...running_var"): the same keys the JAX
package's blocks produce for the same architecture, so a dict read off a
JAX network loads here unchanged. ``random_numpy_params`` draws such a
dict from a seed for tests and smoke runs.

``quantized_state(qnet)`` reads the int8 state of a network
``contrib.quantization.quantize_net`` converted, and
``load_quantized_state(qnet, state)`` writes such a state (for example one
read off the JAX package's quantized layers) into one: the int8 weights and
calibrated thresholds, so that two int8 networks compute with the same
codes.

``transformer_params_from_numpy(tree, cfg)`` takes the JAX package's
transformer parameter tree (``init_params``' structure, layer weights
stacked on a leading [L] axis) as numpy arrays and builds the port's
``TransformerParams``.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["load_numpy_params", "param_shapes", "random_numpy_params",
           "quantized_state", "load_quantized_state",
           "transformer_params_from_numpy"]

_QSTATE_KEYS = ("wq", "w_scale", "act_scale", "bias")


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


def quantized_state(qnet):
    """``{path: {"wq", "w_scale", "act_scale", "bias"}}`` of every int8
    layer of ``qnet`` as numpy: the int8 weight in the float weight's
    layout, the float32 per-channel weight scale, the activation scale
    (threshold / 127, a Python float) and the float bias (None without
    one)."""
    from .contrib.quantization import quantized_layers

    def host(t):
        return None if t is None else t.detach().cpu().numpy()

    return {path: {"wq": host(q._wq), "w_scale": host(q._w_scale),
                   "act_scale": float(q._act_scale), "bias": host(q._bias)}
            for path, q in quantized_layers(qnet).items()}


def load_quantized_state(qnet, state):
    """Write ``state`` (as ``quantized_state`` returns it) into ``qnet``'s
    int8 layers, on the device each layer lives on. Raises KeyError on a
    missing or extra path or entry, and ValueError on a shape or a bias
    that disagrees with the layer; nothing is written then."""
    import torch
    from .contrib.quantization import quantized_layers

    layers = quantized_layers(qnet)
    missing = sorted(set(layers) - set(state))
    extra = sorted(set(state) - set(layers))
    if missing or extra:
        raise KeyError("load_quantized_state: missing paths %s, extra paths "
                       "%s" % (missing, extra))
    for path, q in layers.items():
        entry = state[path]
        if sorted(entry) != sorted(_QSTATE_KEYS):
            raise KeyError("load_quantized_state: %s has entries %s, want %s"
                           % (path, sorted(entry), sorted(_QSTATE_KEYS)))
        want = {"wq": tuple(q._wq.shape), "w_scale": tuple(q._w_scale.shape),
                "bias": None if q._bias is None else tuple(q._bias.shape)}
        for key, shape in want.items():
            got = entry[key]
            got = None if got is None else tuple(np.shape(got))
            if got != shape:
                raise ValueError("load_quantized_state: %s.%s has shape %s, "
                                 "the layer wants %s" % (path, key, got,
                                                         shape))
    for path, q in layers.items():
        entry = state[path]
        dev = q._wq.device

        def t(a, dtype):
            return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

        q._set_state(t(entry["wq"], np.int8), t(entry["w_scale"], np.float32),
                     float(entry["act_scale"]),
                     None if entry["bias"] is None
                     else t(entry["bias"], np.float32))


def transformer_params_from_numpy(tree, cfg, ctx=None):
    """The port's ``TransformerParams`` (``parallel.transformer``) from the
    JAX package's parameter tree as numpy arrays: ``{"embed": [V, D],
    "layers": {"wq": [L, D, H, Dh], ...}, "ln_f": [D], "w_out": [D, V]}``,
    cast to ``cfg.dtype`` on ``ctx``. Raises KeyError on a missing or extra
    key and ValueError on a shape that disagrees with ``cfg``; nothing is
    built then."""
    import torch
    from .base import canonical_dtype
    from .context import as_device
    from .parallel import transformer as T

    T._check_supported(cfg)
    top = {"embed": (cfg.vocab_size, cfg.dim), "ln_f": (cfg.dim,),
           "w_out": (cfg.dim, cfg.vocab_size)}
    layer = {k: (cfg.n_layers,) + s for k, s in T._layer_shapes(cfg).items()}
    missing = sorted((set(top) | {"layers"}) - set(tree))
    extra = sorted(set(tree) - set(top) - {"layers"})
    if not missing:
        missing += ["layers." + k for k in sorted(set(layer)
                                                  - set(tree["layers"]))]
        extra += ["layers." + k for k in sorted(set(tree["layers"])
                                                - set(layer))]
    if missing or extra:
        raise KeyError("transformer_params_from_numpy: missing keys %s, "
                       "extra keys %s" % (missing, extra))
    arrays = {k: np.asarray(tree[k]) for k in top}
    arrays.update({"layers." + k: np.asarray(tree["layers"][k])
                   for k in layer})
    want = dict(top, **{"layers." + k: s for k, s in layer.items()})
    for key, shape in want.items():
        if tuple(arrays[key].shape) != tuple(shape):
            raise ValueError("transformer_params_from_numpy: %s has shape "
                             "%s, the config wants %s"
                             % (key, arrays[key].shape, shape))
    dev = as_device(ctx)
    dt = canonical_dtype(cfg.dtype)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev, dt)

    layers = [{k: t(arrays["layers." + k][i]) for k in layer}
              for i in range(cfg.n_layers)]
    return T.TransformerParams(t(arrays["embed"]), layers, t(arrays["ln_f"]),
                               t(arrays["w_out"]))

"""Checkpoints and the legacy FeedForward model API (counterpart of
mxnet_tpu/model.py; ref: python/mxnet/model.py save_checkpoint :394,
load_checkpoint :442, _create_kvstore :82, _update_params_on_kvstore
:150).

A checkpoint is the reference's file pair: ``prefix-symbol.json`` holds
the graph, ``prefix-%04d.params`` a dict of NDArrays under ``arg:`` and
``aux:`` keys (``nd.save``, the same bytes as the JAX package's), so
either package loads the other's checkpoints.
"""
from __future__ import annotations

import collections

from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "load_params", "FeedForward"]

BatchEndParam = collections.namedtuple(
    "BatchEndParams", ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """ref: model.py:82 -- resolve a kvstore spec to (kv, update_on_kvstore):
    one device and a non-dist name give no store."""
    from . import kvstore as kvs
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(p.size for p in arg_params.values())
                update_on_kvstore = max_size <= 1024 * 1024 * 16
    else:
        raise TypeError("kvstore must be KVStore, str, or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """ref: model.py:110."""
    for idx, param in enumerate(param_arrays):
        name = param_names[idx]
        kvstore.init(name, arg_params[name])
        if update_on_kvstore:
            kvstore.pull(name, param, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """Server-side optimizer mode (ref: model.py:150): push grad, pull
    updated weight."""
    for index, (w, g) in enumerate(zip(param_arrays, grad_arrays)):
        if g is None:
            continue
        name = param_names[index]
        kvstore.push(name, g, priority=-index)
        kvstore.pull(name, w, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """Local optimizer mode (ref: model.py:171): optional kvstore reduce,
    then the updater on the one device copy."""
    for index, (w, g) in enumerate(zip(param_arrays, grad_arrays)):
        if g is None:
            continue
        if kvstore is not None:
            name = param_names[index]
            kvstore.push(name, g, priority=-index)
            kvstore.pull(name, g, priority=-index)
        updater(index, g, w)


def pack_params(arg_params, aux_params):
    """Build the ``arg:``/``aux:``-prefixed checkpoint dict -- the single
    definition of the param-file key convention (ref: model.py:394)."""
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    return save_dict


def unpack_params(save_dict, strict=False):
    """Inverse of pack_params: (arg_params, aux_params)."""
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        elif strict:
            raise ValueError("invalid param key %r" % (k,))
    return arg_params, aux_params


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """ref: model.py:394. Writes prefix-symbol.json + prefix-%04d.params."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, pack_params(arg_params, aux_params))


def load_params(prefix, epoch):
    """ref: model.py load_params -- params only."""
    return unpack_params(nd.load("%s-%04d.params" % (prefix, epoch)))


def load_checkpoint(prefix, epoch):
    """ref: model.py:442 -- (symbol, arg_params, aux_params)."""
    symbol = sym.load("%s-symbol.json" % prefix)
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params


class FeedForward:
    """Legacy model API (ref: model.py:551 FeedForward -- deprecated in the
    reference in favor of Module; provided as a thin veneer over Module for
    script compatibility)."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from .initializer import Uniform
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = begin_epoch
        self.numpy_batch_size = numpy_batch_size
        self._kwargs = kwargs
        self._module = None

    def _make_module(self, data_names, label_names, work_load_list=None,
                     logger=None):
        from .module import Module
        ctx = self.ctx if isinstance(self.ctx, (list, tuple)) or \
            self.ctx is None else [self.ctx]
        kwargs = {}
        if logger is not None:
            kwargs["logger"] = logger
        if ctx is not None:
            kwargs["context"] = ctx
        return Module(self.symbol, data_names=data_names,
                      label_names=label_names,
                      work_load_list=work_load_list, **kwargs)

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None,
            optimizer_params=None):
        train_data = self._as_iter(X, y)
        if eval_data is not None and not hasattr(eval_data, "reset"):
            # (X, y) tuple / arrays, like the reference's _init_eval_iter
            ex, ey = eval_data if isinstance(eval_data, (tuple, list)) \
                else (eval_data, None)
            eval_data = self._as_iter(ex, ey)
        data_names = [d[0] for d in train_data.provide_data]
        label_names = [d[0] for d in train_data.provide_label]
        mod = self._make_module(data_names, label_names,
                                work_load_list=work_load_list, logger=logger)
        mod.fit(train_data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback,
                monitor=monitor,
                optimizer=self.optimizer,
                optimizer_params=optimizer_params or
                {"learning_rate": self._kwargs.get("learning_rate", 0.01)},
                initializer=self.initializer,
                arg_params=self.arg_params, aux_params=self.aux_params,
                begin_epoch=self.begin_epoch, num_epoch=self.num_epoch)
        self._module = mod
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        test_data = self._as_iter(X, None)
        if self._module is None:
            raise MXNetError("model has not been trained")
        outs = self._module.predict(test_data, num_batch=num_batch,
                                    reset=reset)
        if isinstance(outs, list):
            return [o.asnumpy() for o in outs]
        return outs.asnumpy()

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch or 0
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)

    @staticmethod
    def _as_iter(X, y):
        from .io import NDArrayIter, DataIter
        if isinstance(X, DataIter):
            return X
        return NDArrayIter(X, y, batch_size=128)

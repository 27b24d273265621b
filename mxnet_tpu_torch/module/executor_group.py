"""Data-parallel execution group (counterpart of
mxnet_tpu/module/executor_group.py; ref: python/mxnet/module/
executor_group.py:144, decide_slices :282).

The reference binds one executor per device and slices each batch across
them; the JAX package binds one program sharded over the contexts' mesh.
The port binds one executor on one device: a ``contexts`` list of several
devices raises until the multi-device slice (ROADMAP M10).
``decide_slices`` stays, as BucketingModule and user code read it.
"""
from __future__ import annotations

from ..base import MXNetError
from ..context import Context
from ..executor import Executor, _set
from ..io import DataDesc

__all__ = ["DataParallelExecutorGroup"]


def _as_desc(shapes):
    out = []
    for s in shapes or []:
        if isinstance(s, DataDesc):
            out.append(s)
        else:
            name, shape = s[0], s[1]
            out.append(DataDesc(name, tuple(shape)))
    return out


class DataParallelExecutorGroup:
    """One executor on the group's one device."""

    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, fixed_param_names=None, grad_req="write",
                 state_names=None):
        self.symbol = symbol
        self.contexts = [Context(c) for c in contexts]
        if len(set(self.contexts)) > 1:
            raise MXNetError(
                "Module over several devices %s arrives with the "
                "multi-device slice (ROADMAP M10); bind one context"
                % self.contexts)
        self.param_names = list(param_names)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = set(fixed_param_names or [])
        self.data_shapes = _as_desc(data_shapes)
        self.label_shapes = _as_desc(label_shapes)
        self.batch_size = self.data_shapes[0].shape[0]
        self.slices = self.decide_slices(self.data_shapes)

        label_names = {d.name for d in self.label_shapes}
        input_names = {d.name for d in self.data_shapes} | label_names
        arg_names = symbol.list_arguments()
        req = {}
        for name in arg_names:
            if name in input_names:
                req[name] = "write" if (inputs_need_grad and
                                        name not in label_names) \
                    else "null"
            elif name in self.fixed_param_names or not for_training:
                req[name] = "null"
            else:
                req[name] = grad_req if isinstance(grad_req, str) else \
                    grad_req.get(name, "write")
        shapes = {d.name: d.shape for d in self.data_shapes}
        shapes.update({d.name: d.shape for d in self.label_shapes})

        ctx = self.contexts[0]
        if shared_group is not None:
            # share parameter arrays with the donor group (BucketingModule)
            donor = shared_group.executor
            fresh = Executor.simple_bind(symbol, ctx, grad_req=req,
                                         **shapes)
            args = {n: donor.arg_dict[n] if n in donor.arg_dict and tuple(
                donor.arg_dict[n].shape) == tuple(a.shape) else a
                for n, a in fresh.arg_dict.items()}
            aux = {n: donor.aux_dict[n] if n in donor.aux_dict and tuple(
                donor.aux_dict[n].shape) == tuple(a.shape) else a
                for n, a in fresh.aux_dict.items()}
            self.executor = Executor(symbol, ctx, args=args,
                                     args_grad=fresh.grad_dict,
                                     grad_req=req, aux_states=aux)
        else:
            self.executor = Executor.simple_bind(symbol, ctx, grad_req=req,
                                                 **shapes)
        self.execs = [self.executor]   # the reference keeps one per device

    def decide_slices(self, data_shapes):
        """Per-context batch ranges (ref: executor_group.py:282)."""
        n = len(self.contexts)
        bs = data_shapes[0].shape[0]
        step = (bs + n - 1) // n
        slices = []
        start = 0
        for _ in range(n):
            stop = min(start + step, bs)
            slices.append(slice(start, stop))
            start = stop
        return slices

    # -- data movement ------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        feeds = {}
        for desc, arr in zip(self.data_shapes, data_batch.data):
            feeds[desc.name] = arr
        if self.label_shapes and getattr(data_batch, "label", None):
            for desc, arr in zip(self.label_shapes, data_batch.label):
                feeds[desc.name] = arr
        for name, arr in feeds.items():
            tgt = self.executor.arg_dict[name]
            if tuple(arr.shape) != tuple(tgt.shape):
                raise MXNetError(
                    "shape mismatch for %r: got %s, bound %s"
                    % (name, tuple(arr.shape), tuple(tgt.shape)))
            _set(tgt, arr)
        self.executor.forward(is_train=is_train)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to call backward")
        self.executor.backward(out_grads=out_grads)

    # -- views --------------------------------------------------------------
    def get_outputs(self, merge_multi_context=True):
        return list(self.executor.outputs)

    def get_params(self, arg_params, aux_params):
        for n in self.param_names:
            if n in self.executor.arg_dict:
                arg_params[n] = self.executor.arg_dict[n].copy()
        for n, v in self.executor.aux_dict.items():
            aux_params[n] = v.copy()

    def set_params(self, arg_params, aux_params, allow_extra=False):
        self.executor.copy_params_from(arg_params, aux_params,
                                       allow_extra_params=allow_extra)

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        return [self.executor.grad_dict.get(d.name)
                for d in self.data_shapes]

    @property
    def grad_arrays(self):
        """grads in param_names order (None where grad_req='null')."""
        return [self.executor.grad_dict.get(n) for n in self.param_names]

    @property
    def param_arrays(self):
        return [self.executor.arg_dict[n] for n in self.param_names
                if n in self.executor.arg_dict]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    def install_monitor(self, mon):
        mon.install(self.executor)

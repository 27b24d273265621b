"""Module: the intermediate-level symbolic training API (counterpart of
mxnet_tpu/module/module.py; ref: python/mxnet/module/module.py Module :52,
bind :364, init_params :242, init_optimizer :474, forward :575, backward
:626, update :646, save_checkpoint :165, load :130).

A Module owns one executor group on one device, ``gpu(0)`` unless the
caller gives ``context`` (the JAX package's default is the CPU). The
update runs the optimizer's per-parameter ``Updater`` (with one device and
``kvstore="local"`` there is no store, as in the reference), or the
kvstore's push and pull (ref: python/mxnet/model.py:150).
"""
from __future__ import annotations

import logging

from .. import optimizer as opt
from ..context import Context, gpu
from ..executor import _set, _tensor_of
from ..initializer import InitDesc, Uniform
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint,
                     save_checkpoint)
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup, _as_desc

__all__ = ["Module"]


class Module(BaseModule):
    """ref: module.py:52."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if context is None:
            context = gpu(0)
        if isinstance(context, (list, tuple)):
            self._context = list(context)
        else:
            self._context = [context]
        for c in self._context:
            Context(c).device        # raises for a GPU with no CUDA
        self._work_load_list = work_load_list
        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        state_names = list(state_names) if state_names is not None else []
        fixed_param_names = list(fixed_param_names) \
            if fixed_param_names is not None else []
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, state_names, "state", True)
        _check_input_names(symbol, fixed_param_names, "fixed_param", True)

        arg_names = symbol.list_arguments()
        input_names = data_names + label_names + state_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = fixed_param_names
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = state_names
        self._output_names = symbol.list_outputs()
        self._compression_params = compression_params

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False

        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._preload_opt_states = None
        self._grad_req = None

    # -- serialization ------------------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """ref: module.py:130."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        """ref: module.py:165."""
        self._sync_params_from_devices()
        save_checkpoint(prefix, epoch, self.symbol, self._arg_params,
                        self._aux_params, remove_amp_cast=remove_amp_cast)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)

    # -- properties ---------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        outs = self._exec_group.executor.outputs
        if outs:
            return list(zip(self._output_names, [o.shape for o in outs]))
        shapes = {d.name: d.shape for d in self._data_shapes}
        shapes.update({d.name: d.shape for d in self._label_shapes or []})
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self._output_names, out_shapes))

    # -- parameters ---------------------------------------------------------
    def get_params(self):
        """ref: module.py get_params."""
        assert self.binded and self.params_initialized
        self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    _DEFAULT_INIT = object()

    def init_params(self, initializer=_DEFAULT_INIT, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """ref: module.py:242 (signature default Uniform(0.01) there, so
        params absent from arg_params/aux_params still get initialized --
        while set_params' explicit initializer=None disables fallback)."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is Module._DEFAULT_INIT:
            initializer = Uniform(0.01)

        if self._arg_params is None:
            self._arg_params = {
                n: self._exec_group.executor.arg_dict[n]
                for n in self._param_names
                if n in self._exec_group.executor.arg_dict}
        if self._aux_params is None:
            self._aux_params = dict(self._exec_group.executor.aux_dict)

        var_attrs = self._symbol.attr_dict

        def _impl(name, arr, cache):
            # mirrors the reference's _impl (module.py:267): cached value
            # wins; a missing name raises unless allow_missing, in which
            # case (and when no cache was given at all) the initializer runs
            if cache is not None:
                if name in cache:
                    src = cache[name]
                    if src is not arr:
                        _set(arr, _tensor_of(src).reshape(arr.shape))
                    return
                if not allow_missing:
                    raise RuntimeError("%s is not presented" % name)
            if initializer is not None:
                # variable attrs carry per-param init overrides (__init__)
                initializer(InitDesc(name, attrs=var_attrs.get(name)), arr)

        for name, arr in sorted(self._arg_params.items()):
            _impl(name, arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            _impl(name, arr, aux_params)

        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params,
                                    allow_extra=True)

    def _sync_params_from_devices(self):
        """ref: module.py _sync_params_from_devices. Buffers are shared with
        the executor, so this only refreshes the dict views."""
        if not self.binded or not self.params_initialized:
            return
        exe = self._exec_group.executor
        for n in self._param_names:
            if n in exe.arg_dict:
                self._arg_params[n] = exe.arg_dict[n]
        for n, v in exe.aux_dict.items():
            self._aux_params[n] = v
        self._params_dirty = False

    # -- binding ------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """ref: module.py:364."""
        if force_rebind:
            self._exec_group = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        if not for_training:
            assert not inputs_need_grad

        self._data_shapes = _as_desc(data_shapes)
        self._label_shapes = _as_desc(label_shapes) if label_shapes else []

        shared_group = None
        if shared_module is not None:
            assert shared_module.binded
            shared_group = shared_module._exec_group

        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, shared_group=shared_group,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            state_names=self._state_names)
        self.binded = True

        if shared_module is not None and shared_module.params_initialized:
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            self.params_initialized = True
        elif self.params_initialized:
            # load() path: params arrived before bind
            self._exec_group.set_params(self._arg_params, self._aux_params,
                                        allow_extra=True)
            self._arg_params = {
                n: self._exec_group.executor.arg_dict[n]
                for n in self._param_names
                if n in self._exec_group.executor.arg_dict}
            self._aux_params = dict(self._exec_group.executor.aux_dict)

    def reshape(self, data_shapes, label_shapes=None):
        """ref: module.py reshape -- switch executors on new shapes, keeping
        parameters. Executor groups are cached per shape signature (like
        BucketingModule's per-bucket executors), so alternating batch
        geometries (a smaller last batch every epoch) reuse their bound
        arrays."""
        assert self.binded
        arg_params, aux_params = (self._arg_params, self._aux_params) \
            if self.params_initialized else (None, None)
        if self.params_initialized:
            self._sync_params_from_devices()
        old_group = self._exec_group

        if not hasattr(self, "_exec_cache"):
            # LRU-bounded: workloads that reshape to many distinct
            # geometries must not retain every compiled executor forever
            from collections import OrderedDict
            self._exec_cache = OrderedDict()
        curr_key = (tuple((d.name, tuple(d.shape))
                          for d in self._data_shapes),
                    tuple((d.name, tuple(d.shape))
                          for d in self._label_shapes or []))
        self._exec_cache[curr_key] = old_group
        self._exec_cache.move_to_end(curr_key)

        new_data = _as_desc(data_shapes)
        new_label = _as_desc(label_shapes) if label_shapes else []
        new_key = (tuple((d.name, tuple(d.shape)) for d in new_data),
                   tuple((d.name, tuple(d.shape)) for d in new_label))
        cached = self._exec_cache.get(new_key)
        if cached is not None:
            self._exec_group = cached
            self._exec_cache.move_to_end(new_key)
            self._data_shapes = new_data
            self._label_shapes = new_label
        else:
            self.binded = False
            self._exec_group = None
            self.bind(data_shapes, label_shapes,
                      for_training=self.for_training,
                      inputs_need_grad=self.inputs_need_grad,
                      force_rebind=True, grad_req=self._grad_req or "write")
            self._exec_cache[new_key] = self._exec_group
        while len(self._exec_cache) > 8:
            self._exec_cache.popitem(last=False)
        if arg_params is not None:
            self._exec_group.set_params(arg_params, aux_params,
                                        allow_extra=True)
            self._sync_params_from_devices()
            self.params_initialized = True
        if old_group is not None and self._exec_group is not old_group \
                and self._grad_req == "add":
            # carry accumulated parameter gradients across the switch
            old_g = old_group.executor.grad_dict
            new_g = self._exec_group.executor.grad_dict
            for n, g in old_g.items():
                tgt = new_g.get(n)
                if tgt is not None and tgt.shape == g.shape:
                    _set(tgt, g)

    # -- optimizer ----------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """ref: module.py:474."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()

        kv, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        batch_size = self._exec_group.batch_size
        if kv and "dist" in kv.type and "_sync" in kv.type:
            batch_size *= kv.num_workers
        rescale_grad = 1.0 / batch_size
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._param_names))
            optimizer_params = dict(optimizer_params)
            # normalize the batch-summed gradient unless the caller chose
            # their own scale (ref: module.py:498 init_optimizer)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = rescale_grad
            optimizer = opt.create(optimizer,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
            # per-variable __lr_mult__/__wd_mult__ attrs (sym.Variable
            # lr_mult=...) flow into the optimizer like the reference's
            # attr_dict wiring (ref: module.py:502 init_optimizer)
            attrs = self._symbol.attr_dict
            lr_mult = {n: float(a["__lr_mult__"])
                       for n, a in attrs.items() if "__lr_mult__" in a}
            wd_mult = {n: float(a["__wd_mult__"])
                       for n, a in attrs.items() if "__wd_mult__" in a}
            if lr_mult:
                optimizer.set_lr_mult(lr_mult)
            if wd_mult:
                optimizer.set_wd_mult(wd_mult)
        else:
            if optimizer.rescale_grad != rescale_grad:
                self.logger.warning(
                    "Optimizer created manually outside Module but "
                    "rescale_grad is not normalized to 1.0/batch_size "
                    "(%s vs. %s). Is this intended?",
                    optimizer.rescale_grad, rescale_grad)
        self._optimizer = optimizer
        self._kvstore = kv
        self._update_on_kvstore = update_on_kvstore
        self._updater = None

        if kv is not None:
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            _initialize_kvstore(kvstore=kv,
                                param_arrays=self._exec_group.param_arrays,
                                arg_params=self._arg_params,
                                param_names=self._param_names,
                                update_on_kvstore=update_on_kvstore)
            if update_on_kvstore:
                kv.set_optimizer(self._optimizer)
        if not update_on_kvstore:
            self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True

        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """ref: module.py borrow_optimizer (BucketingModule support)."""
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    # -- computation --------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        """ref: module.py:575. Reshapes on the fly if the batch geometry
        changed (last-batch handling), like the reference."""
        assert self.binded and self.params_initialized
        curr = {d.name: d.shape for d in self._data_shapes}
        new_shapes = {}
        for desc, arr in zip(self._data_shapes, data_batch.data):
            shape = tuple(arr.shape)
            if curr[desc.name] != shape:
                new_shapes[desc.name] = shape
        if new_shapes:
            new_data = [(d.name, new_shapes.get(d.name, d.shape))
                        for d in self._data_shapes]
            new_label = None
            if self._label_shapes and getattr(data_batch, "label", None):
                new_label = [(d.name, tuple(a.shape)) for d, a in
                             zip(self._label_shapes, data_batch.label)]
            self.reshape(new_data, new_label)
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        """ref: module.py:626."""
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """ref: module.py:646 -> model.py:150/171."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._params_dirty = True
        if self._update_on_kvstore:
            _update_params_on_kvstore(self._exec_group.param_arrays,
                                      self._exec_group.grad_arrays,
                                      self._kvstore, self._param_names)
        else:
            _update_params(self._exec_group.param_arrays,
                           self._exec_group.grad_arrays,
                           updater=self._updater,
                           num_device=len(self._context),
                           kvstore=self._kvstore,
                           param_names=self._param_names)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._exec_group.update_metric(eval_metric, labels)

    # -- optimizer state ----------------------------------------------------
    def save_optimizer_states(self, fname):
        """ref: module.py save_optimizer_states."""
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
        else:
            with open(fname, "wb") as fout:
                fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        """ref: module.py load_optimizer_states."""
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as fin:
                self._updater.set_states(fin.read())

    def install_monitor(self, mon):
        assert self.binded
        self._exec_group.install_monitor(mon)

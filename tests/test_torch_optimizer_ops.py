"""The port's optimizer update ops held against the JAX package's on the
CPU: every pure registry form (mxnet_tpu_torch/ops/optimizer_ops.py
against mxnet_tpu/ops/optimizer_ops.py) and every ``nd.*_update`` wrapper
(mxnet_tpu_torch/ndarray/optimizer_ops.py against
mxnet_tpu/ndarray/optimizer_ops.py), on the same inputs drawn with numpy.

The pure forms return every updated tensor; the wrappers write each state
in place and the new weight into ``out`` (the ``mp_*`` forms into the
weight when no ``out`` is given), and the port's wrappers must leave every
tensor as JAX's leave theirs. Every f32 result within RTOL of its largest
magnitude, every bf16 one (the ``mp_*`` forms' weights) within BF16_RTOL.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import registry as treg

# f32 results: the same elementwise chain in both; XLA:CPU may contract a
# multiply-add into an FMA, a few ulps
RTOL = 1e-6
# bf16 results cast from f32 values within RTOL: one bf16 ulp of the max
BF16_RTOL = 2.0 ** -8

SHAPE = (5, 6)
H = dict(wd=1e-3, rescale_grad=0.5, clip_gradient=0.8)


def _arr(seed, kind="normal", dtype="float32", shape=SHAPE):
    rs = np.random.RandomState(seed)
    a = {"normal": lambda: rs.randn(*shape),
         "small": lambda: rs.randn(*shape) * 0.1,
         "uniform": lambda: rs.rand(*shape) + 0.05}[kind]()
    return (a.astype("float32"), dtype)


# op name -> (inputs as (array, dtype) in order, hyperparameters); the
# states that must stay non-negative are drawn uniform, and rmspropalex's
# mean gradient small beside its n
CASES = {
    "sgd_update": ([_arr(0), _arr(1)], dict(H, lr=0.1)),
    "sgd_mom_update": ([_arr(0), _arr(1), _arr(2)],
                       dict(H, lr=0.1, momentum=0.9)),
    "mp_sgd_update": ([_arr(0, dtype="bfloat16"), _arr(1, dtype="bfloat16"),
                       _arr(0)], dict(H, lr=0.1)),
    "mp_sgd_mom_update": ([_arr(0, dtype="bfloat16"),
                           _arr(1, dtype="bfloat16"), _arr(2), _arr(0)],
                          dict(H, lr=0.1, momentum=0.9)),
    "nag_mom_update": ([_arr(0), _arr(1), _arr(2)],
                       dict(H, lr=0.1, momentum=0.9)),
    "mp_nag_mom_update": ([_arr(0, dtype="bfloat16"),
                           _arr(1, dtype="bfloat16"), _arr(2), _arr(0)],
                          dict(H, lr=0.1, momentum=0.9)),
    "adam_update": ([_arr(0), _arr(1), _arr(2), _arr(3, "uniform")],
                    dict(H, lr=0.01, beta1=0.8, beta2=0.99, epsilon=1e-6)),
    "rmsprop_update": ([_arr(0), _arr(1), _arr(3, "uniform")],
                       dict(H, lr=0.01, gamma1=0.9, epsilon=1e-6,
                            clip_weights=1.2)),
    "rmspropalex_update": ([_arr(0), _arr(1), _arr(3, "uniform"),
                            _arr(4, "small"), _arr(5)],
                           dict(H, lr=0.01, gamma1=0.9, gamma2=0.8,
                                epsilon=1e-6)),
    "ftrl_update": ([_arr(0), _arr(1), _arr(2), _arr(3, "uniform")],
                    dict(H, lr=0.1, lamda1=0.3, beta=1.5)),
    "ftml_update": ([_arr(0), _arr(1), _arr(3, "uniform"),
                     _arr(4, "uniform"), _arr(5)],
                    dict(wd=1e-3, rescale_grad=0.5, clip_grad=0.8, lr=0.05,
                         t=3, beta1=0.6, beta2=0.99)),
    "signsgd_update": ([_arr(0), _arr(1)], dict(H, lr=0.01)),
    "signum_update": ([_arr(0), _arr(1), _arr(2)],
                      dict(H, lr=0.01, momentum=0.9, wd_lh=1e-3)),
    "adamw_update": ([_arr(0), _arr(1), _arr(2), _arr(3, "uniform")],
                     dict(H, lr=0.01, eta=0.9, beta1=0.8, beta2=0.99)),
    "mp_adamw_update": ([_arr(0, dtype="bfloat16"),
                         _arr(1, dtype="bfloat16"), _arr(2),
                         _arr(3, "uniform"), _arr(0)],
                        dict(H, lr=0.01, eta=0.9)),
    "lamb_update_phase1": ([_arr(0), _arr(1), _arr(2), _arr(3, "uniform")],
                           dict(H, lr=0.01, t=3, beta1=0.8, beta2=0.99)),
    "lamb_update_phase2": ([_arr(0), _arr(1), _arr(6, "uniform", shape=(1,)),
                            _arr(7, "uniform", shape=(1,))],
                           dict(lr=0.01, lower_bound=0.3, upper_bound=0.9)),
    "sparse_adagrad_update": ([_arr(0), _arr(1), _arr(3, "uniform")],
                              dict(H, lr=0.1, epsilon=1e-6)),
    "group_adagrad_update": ([_arr(0), _arr(1), _arr(3, "uniform")],
                             dict(H, lr=0.1)),
    "multi_lars": ([_arr(8, "uniform", shape=(4,)),
                    _arr(9, "uniform", shape=(4,)),
                    _arr(10, "uniform", shape=(4,)),
                    _arr(11, "uniform", shape=(4,))],
                   dict(eta=0.01, eps=1e-8, rescale_grad=0.5)),
    "multi_sgd_update": ([_arr(0), _arr(1), _arr(2), _arr(3)],
                         dict(lrs=[0.1, 0.2], wds=[1e-3, 0.0], num_weights=2,
                              rescale_grad=0.5, clip_gradient=0.8)),
    "multi_sgd_mom_update": ([_arr(0), _arr(1), _arr(2), _arr(3), _arr(4),
                              _arr(5)],
                             dict(lrs=[0.1, 0.2], wds=[1e-3, 0.0],
                                  num_weights=2, momentum=0.9,
                                  rescale_grad=0.5)),
    "multi_mp_sgd_update": ([_arr(0, dtype="bfloat16"),
                             _arr(1, dtype="bfloat16"), _arr(0),
                             _arr(3, dtype="bfloat16"),
                             _arr(4, dtype="bfloat16"), _arr(3)],
                            dict(lrs=[0.1, 0.2], wds=[1e-3, 0.0],
                                 num_weights=2, clip_gradient=0.8)),
    "multi_mp_sgd_mom_update": ([_arr(0, dtype="bfloat16"),
                                 _arr(1, dtype="bfloat16"), _arr(2), _arr(0),
                                 _arr(3, dtype="bfloat16"),
                                 _arr(4, dtype="bfloat16"), _arr(5),
                                 _arr(3)],
                                dict(lrs=[0.1, 0.2], wds=[1e-3, 0.0],
                                     num_weights=2, momentum=0.9)),
}
# the preloaded forms: the multi forms' inputs, then lrs and wds tensors
for _name in ("sgd", "sgd_mom", "mp_sgd", "mp_sgd_mom"):
    _ins, _kw = CASES["multi_%s_update" % _name]
    _kw = dict(_kw)
    _lrs, _wds = _kw.pop("lrs"), _kw.pop("wds")
    CASES["preloaded_multi_%s_update" % _name] = (
        _ins + [(np.array(_lrs, "float32"), "float32"),
                (np.array(_wds, "float32"), "float32")], _kw)

# the wrapper's (position of each input it writes in place); the new weight
# goes to out= (or, for mp_* without out, into input 0)
STATES = {
    "sgd_mom_update": (2,), "mp_sgd_update": (2,),
    "mp_sgd_mom_update": (2, 3), "nag_mom_update": (2,),
    "mp_nag_mom_update": (2, 3), "adam_update": (2, 3),
    "rmsprop_update": (2,), "rmspropalex_update": (2, 3, 4),
    "ftrl_update": (2, 3), "ftml_update": (2, 3, 4), "signum_update": (2,),
    "adamw_update": (2, 3), "mp_adamw_update": (2, 3, 4),
    "lamb_update_phase1": (2, 3), "sparse_adagrad_update": (2,),
    "group_adagrad_update": (2,),
}


def _torch(a, dtype):
    return torch.from_numpy(a.copy()).to(getattr(torch, dtype))


def _jnp(a, dtype):
    return jnp.asarray(a.copy()).astype(dtype)


def _close_dt(t, j):
    """t within the bound of its dtype (RTOL or BF16_RTOL) of JAX's j,
    relative to j's largest magnitude."""
    t_np = t.detach().float().numpy()
    j = np.asarray(j.astype(jnp.float32) if hasattr(j, "astype") else j,
                   dtype="float32")
    tol = BF16_RTOL if t.dtype == torch.bfloat16 else RTOL
    scale = max(float(np.abs(j).max()), 1e-30)
    assert t_np.shape == j.shape
    assert float(np.abs(t_np - j).max()) <= tol * scale


@pytest.mark.parametrize("name", sorted(CASES))
def test_pure_form_matches_jax(name):
    """The registry form on both sides: every output within its bound, no
    input written."""
    ins, kw = CASES[name]
    tin = [_torch(a, dt) for a, dt in ins]
    before = [t.clone() for t in tin]
    got = treg.get_op(name).fn(*tin, **kw)
    want = jreg.get_op(name).fn(*[_jnp(a, dt) for a, dt in ins], **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for t, j in zip(got, want):
        assert t.dtype == getattr(torch, str(j.dtype)), name
        _close_dt(t, j)
    assert all(torch.equal(a, b) for a, b in zip(tin, before))


@pytest.mark.parametrize("name", sorted(CASES))
def test_nd_wrapper_writes_in_place_like_jax(name):
    """nd.<name> with out= on both sides (out= the weight for the multi
    forms): the returned tensors, out and every input afterwards within
    their bounds of JAX's; the returned weight is out itself."""
    ins, kw = CASES[name]
    tin = [_torch(a, dt) for a, dt in ins]
    jin = [mxj.nd.array(np.asarray(a, "float32"), dtype=dt)
           for a, dt in ins]
    multi = name.startswith(("multi_sgd", "multi_mp", "preloaded"))
    if multi:
        n_per = len(ins[:-2] if name.startswith("preloaded") else ins) \
            // kw["num_weights"]
        tout = [tin[i * n_per] for i in range(kw["num_weights"])]
        jout = [jin[i * n_per] for i in range(kw["num_weights"])]
    else:
        tout = torch.zeros_like(tin[0]) if name != "multi_lars" \
            else torch.zeros(4)
        jout = mxj.nd.zeros(tuple(tout.shape),
                            dtype=str(tout.dtype).replace("torch.", ""))
    got = getattr(mx.nd, name)(*tin, out=tout, **kw)
    want = getattr(mxj.nd, name)(*jin, out=jout, **kw)
    if multi:
        assert all(g is o for g, o in zip(got, tout))
        for g, w in zip(got, want):
            _close_dt(g, w.asnumpy())
    else:
        assert got is tout
        _close_dt(got, want.asnumpy())
        _close_dt(tout, jout.asnumpy())
    for i, (t, j) in enumerate(zip(tin, jin)):
        _close_dt(t, j.asnumpy())
    for i in STATES.get(name, ()):            # the states moved
        assert not np.array_equal(tin[i].float().numpy(),
                                  np.asarray(ins[i][0], "float32")), i


@pytest.mark.parametrize("name", ["mp_sgd_update", "mp_sgd_mom_update",
                                  "mp_nag_mom_update", "mp_adamw_update"])
def test_mp_wrapper_writes_the_weight_without_out(name):
    """Without out= an mp_* wrapper writes the new bf16 weight into the
    weight it was given, as JAX's does."""
    ins, kw = CASES[name]
    tin = [_torch(a, dt) for a, dt in ins]
    jin = [mxj.nd.array(np.asarray(a, "float32"), dtype=dt)
           for a, dt in ins]
    got = getattr(mx.nd, name)(*tin, **kw)
    getattr(mxj.nd, name)(*jin, **kw)
    assert got is tin[0]
    for t, j in zip(tin, jin):
        _close_dt(t, j.asnumpy())


def test_registry_and_namespace():
    """Every pure form is registered in the port's registry under the JAX
    package's name (aliases too), and nd's names are the in-place
    wrappers."""
    for name in CASES:
        assert name in treg.list_ops() and name in jreg.list_ops(), name
        assert getattr(mx.nd, name).__module__ \
            == "mxnet_tpu_torch.ndarray.optimizer_ops", name

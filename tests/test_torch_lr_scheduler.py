"""The port's learning-rate schedules (mxnet_tpu_torch/lr_scheduler.py)
against the JAX package's (mxnet_tpu/lr_scheduler.py): the same float for
every num_update 0..300, warmup included (exact equality: both are plain
Python arithmetic), and an optimizer whose rate a schedule steps."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu import lr_scheduler as jls
from mxnet_tpu import optimizer as jopt
from mxnet_tpu_torch import lr_scheduler as tls
from mxnet_tpu_torch import optimizer as topt

CASES = [
    ("FactorScheduler", dict(step=10, factor=0.5, base_lr=1.0)),
    ("FactorScheduler", dict(step=7, factor=0.9, stop_factor_lr=0.05,
                             base_lr=0.4, warmup_steps=20,
                             warmup_begin_lr=0.01)),
    ("FactorScheduler", dict(step=3, factor=0.8, warmup_steps=5,
                             warmup_begin_lr=0.002,
                             warmup_mode="constant")),
    ("MultiFactorScheduler", dict(step=[5, 10, 150], factor=0.1,
                                  base_lr=1.0)),
    ("MultiFactorScheduler", dict(step=(30, 60), factor=0.5, base_lr=0.1,
                                  warmup_steps=25, warmup_begin_lr=0.001)),
    ("PolyScheduler", dict(max_update=250, base_lr=1.0, pwr=2,
                           warmup_steps=10, warmup_begin_lr=0.0)),
    ("PolyScheduler", dict(max_update=100, base_lr=0.3, pwr=1.5,
                           final_lr=0.01)),
    ("CosineScheduler", dict(max_update=100, base_lr=1.0, final_lr=0.1)),
    ("CosineScheduler", dict(max_update=280, base_lr=0.5, final_lr=0.0,
                             warmup_steps=40, warmup_begin_lr=0.05,
                             warmup_mode="constant")),
]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_schedule_matches_jax_exactly(name, kw):
    """lr(t) for t = 0..300 equal as floats; re-pointing base_lr (what the
    optimizer does) moves both alike."""
    t, j = getattr(tls, name)(**kw), getattr(jls, name)(**kw)
    assert [t(n) for n in range(301)] == [j(n) for n in range(301)]
    t.base_lr = j.base_lr = 0.25
    assert [t(n) for n in range(301)] == [j(n) for n in range(301)]


@pytest.mark.parametrize("name,kw", [
    ("FactorScheduler", dict(step=0)),
    ("FactorScheduler", dict(step=5, factor=1.5)),
    ("MultiFactorScheduler", dict(step=5)),
    ("MultiFactorScheduler", dict(step=[5, 5])),
    ("PolyScheduler", dict(max_update=0)),
    ("CosineScheduler", dict(max_update=10, warmup_steps=-1)),
    ("CosineScheduler", dict(max_update=10, warmup_mode="cubic")),
    ("LRScheduler", dict(base_lr=0.1, warmup_begin_lr=0.2))])
def test_bad_arguments_raise_as_in_jax(name, kw):
    with pytest.raises(ValueError):
        getattr(jls, name)(**kw)
    with pytest.raises(ValueError):
        getattr(tls, name)(**kw)


@pytest.mark.parametrize("opt", ["sgd", "adam", "rmsprop"])
def test_optimizer_with_scheduler_steps_its_lr(opt):
    """An optimizer given a schedule takes lr = schedule(num_update) at
    each update (the counterpart of tests/test_optimizer.py's
    test_optimizer_with_scheduler_steps_lr): the rates and the updated
    weights equal JAX's, the rates exactly, the weights within 1e-6 of
    their largest magnitude; set_learning_rate then raises."""
    kw = dict(learning_rate=1.0)
    to = topt.create(opt, lr_scheduler=tls.FactorScheduler(step=2,
                                                           factor=0.5),
                     **kw)
    jo = jopt.create(opt, lr_scheduler=jls.FactorScheduler(step=2,
                                                           factor=0.5),
                     **kw)
    tu, ju = topt.get_updater(to), jopt.get_updater(jo)
    w = np.linspace(-1, 1, 6).astype("float32")
    tw, jw = torch.from_numpy(w.copy()), mxj.nd.array(w)
    rates = []
    for step in range(6):
        g = np.random.RandomState(step).randn(6).astype("float32")
        tu(0, torch.from_numpy(g), tw)
        ju(0, mxj.nd.array(g), jw)
        assert to._get_lr(0) == jo._get_lr(0)
        rates.append(to._get_lr(0))
    assert rates[-1] < 1.0 and rates == sorted(rates, reverse=True)
    assert np.abs(tw.numpy() - jw.asnumpy()).max() \
        <= 1e-6 * np.abs(jw.asnumpy()).max()
    with pytest.raises(UserWarning):
        to.set_learning_rate(0.1)

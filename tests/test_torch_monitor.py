"""mx.monitor.Monitor of the port (mxnet_tpu_torch/monitor.py) against the
JAX package's (mxnet_tpu/monitor.py).

The same narrow nets, weights and batches go through both packages under
a Monitor: a Gluon MLP trained eagerly (the tic/toc sweep of every weight
and gradient; the JAX package's blocks call no forward hook, so the port's
hook rows, taken under autograd.record too, are held to the output they
observe), an executor with the
monitor's stat_helper as its monitor callback (the output rows after
forward, then the arg and gradient sweep of an installed executor), and
Module.fit(monitor=). Rows are (batch, name, stat) with the same names in
the same order and stats within 1e-5.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx
from mxnet_tpu.monitor import Monitor as JMonitor
from mxnet_tpu_torch.monitor import Monitor

TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu(), mxj.cpu():
        yield


def _rows_close(got, want):
    assert [(b, n) for b, n, _ in got] == [(b, n) for b, n, _ in want]
    for (_, n, g), (_, _, w) in zip(got, want):
        g = np.array(g.split(), np.float64)
        w = np.array(w.split(), np.float64)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=n)


def _mlp(pkg, seed=0):
    rs = np.random.RandomState(seed)
    net = pkg.gluon.nn.Sequential(prefix="mlp_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(16, in_units=8, activation="relu",
                                   prefix="fc1_"),
                pkg.gluon.nn.Dense(4, in_units=16, prefix="fc2_"))
    net.initialize(ctx=pkg.cpu())
    for _, p in sorted(net.collect_params().items()):
        p.set_data(pkg.nd.array(rs.uniform(-0.5, 0.5, p.shape)
                                .astype("float32"), ctx=pkg.cpu()))
    return net


@pytest.mark.parametrize("pattern,interval", [(".*", 1), (".*weight.*", 2)])
def test_gluon_rows_equal_jax(pattern, interval):
    rs = np.random.RandomState(1)
    batches = [(rs.rand(5, 8).astype("float32"),
                rs.rand(5, 4).astype("float32")) for _ in range(2)]
    rows = []
    for pkg, mon_cls in ((mxj, JMonitor), (mx, Monitor)):
        net = _mlp(pkg)
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1})
        loss_fn = pkg.gluon.loss.L2Loss()
        mon = mon_cls(interval, pattern=pattern, sort=True)
        mon.install(net)
        got = []
        for x, y in batches:
            mon.tic()
            with pkg.autograd.record():
                loss = loss_fn(net(pkg.nd.array(x)), pkg.nd.array(y))
            loss.backward()
            trainer.step(x.shape[0])
            got.append(mon.toc())
        rows.append(got)
    # the JAX package's blocks call no forward hook, so its rows hold no
    # output row; the port's hook rows are held to the values below
    outs = [[r for r in t if r[1] == "mlp_output0"] for t in rows[1]]
    for t, j in zip(rows[1], rows[0]):
        _rows_close([r for r in t if r[1] != "mlp_output0"], j)
    assert sum(len(r) for r in rows[1]) > 0
    assert [len(o) for o in outs] == ([1, 1] if interval == 1
                                      and pattern == ".*" else [0, 0])


def test_hook_rows_under_record():
    """The port runs eagerly: a block's hook rows are taken under
    autograd.record too, on the values the step computes."""
    net = _mlp(mx)
    mon = Monitor(1, pattern=".*output.*")
    mon.install(net)
    x = mx.nd.array(np.ones((2, 8), np.float32))
    mon.tic()
    with mx.autograd.record():
        out = net(x)
    rows = mon.toc()
    assert [n for _, n, _ in rows] == ["mlp_output0"]
    np.testing.assert_allclose(float(rows[0][2]),
                               float(out.abs().mean().asscalar()),
                               rtol=1e-6)


def _sym_mlp(pkg):
    sym = pkg.sym
    fc1 = sym.FullyConnected(sym.var("data"), num_hidden=6, name="fc1")
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act, num_hidden=3, name="fc2")
    return sym.SoftmaxOutput(fc2, sym.var("softmax_label"), name="softmax")


def test_executor_rows_equal_jax():
    rs = np.random.RandomState(2)
    args = {"data": rs.rand(4, 5).astype("float32"),
            "fc1_weight": rs.uniform(-.5, .5, (6, 5)).astype("float32"),
            "fc1_bias": rs.uniform(-.5, .5, (6,)).astype("float32"),
            "fc2_weight": rs.uniform(-.5, .5, (3, 6)).astype("float32"),
            "fc2_bias": rs.uniform(-.5, .5, (3,)).astype("float32"),
            "softmax_label": np.array([0, 2, 1, 1], np.float32)}
    rows = []
    for pkg, mon_cls in ((mxj, JMonitor), (mx, Monitor)):
        with pkg.name.NameManager():
            sym = _sym_mlp(pkg)
        exe = sym.bind(pkg.cpu(),
                       args={k: pkg.nd.array(v) for k, v in args.items()},
                       args_grad={k: pkg.nd.zeros(v.shape)
                                  for k, v in args.items()})
        mon = mon_cls(1, sort=True)
        mon.install(exe)
        exe.set_monitor_callback(mon.stat_helper)
        mon.tic()
        exe.forward(is_train=True)
        exe.backward()
        rows.append(mon.toc())
    _rows_close(rows[1], rows[0])
    names = [n for _, n, _ in rows[1]]
    assert "softmax_output" in names and "fc1_weight_grad" in names


def test_module_fit_installs_the_monitor():
    rs = np.random.RandomState(3)
    x = rs.rand(8, 5).astype("float32")
    y = rs.randint(0, 3, (8,)).astype("float32")
    it = mx.io.NDArrayIter(x, y, batch_size=4, label_name="softmax_label")
    with mx.name.NameManager():
        mod = mx.mod.Module(_sym_mlp(mx), context=mx.cpu())
    mon = Monitor(1, pattern=".*weight.*")
    seen = []
    real = mon.toc

    def toc():
        rows = real()
        seen.append(rows)
        return rows
    mon.toc = toc
    mod.fit(it, num_epoch=1, monitor=mon, optimizer_params=(
        ("learning_rate", 0.1),))
    assert len(seen) == 2
    assert [n for _, n, _ in seen[0]] == ["fc1_weight", "fc2_weight",
                                          "fc1_weight_grad",
                                          "fc2_weight_grad"]
    assert all(np.isfinite(float(v)) for rows in seen for _, _, v in rows)
    assert torch.is_tensor(mod._exec_group.executor.arg_dict[
        "fc1_weight"]._data)

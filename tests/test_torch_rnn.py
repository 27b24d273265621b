"""The port's fused ``RNN`` op, ``gluon.rnn`` and ``gluon.contrib.rnn``
held against the JAX package's on the CPU, f32, from the same numpy
inputs.

- ``RNN``: every mode, one and two directions, 2 layers, T 5, N 3, I 4,
  H 6: outputs and final states within 1e-5 of each tensor's largest
  value; gradients with respect to data, parameters and states
  (``jax.vjp`` against autograd, one cotangent for every output) within
  1e-4. Valid lengths (the lengths in the ``state_cell`` slot for modes
  without a cell state), the per-step state clip, the packing
  arithmetic, dropout between layers, ``nd.RNN`` and ``sym.RNN``.
- ``gluon.rnn``: ``RNN``, ``LSTM``, ``GRU`` with the JAX layer's weights
  carried by ``convert.load_numpy_params``, in both layouts, with and
  without states; each cell's ``unroll`` with ``valid_length``; the
  modifier, sequential and bidirectional cells; ``unfuse()`` against the
  fused layer.
- ``gluon.contrib.rnn``: ``LSTMPCell``, ``VariationalDropoutCell`` and the
  convolutional cells (their convolutions sum in another order: 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.ops import nn as tnn

FWD = 1e-5    # f32 against f32: summation order only
GRAD = 1e-4   # gradients through T steps of the recurrence
CONV = 1e-4   # convolutions sum in another order than XLA's
T, N, I, H, L = 5, 3, 4, 6, 2
MODES = ["lstm", "gru", "rnn_tanh", "rnn_relu"]


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def op_inputs(mode, ndir, seed=0, lengths=False):
    rs = np.random.RandomState(seed)
    n = jnn.rnn_packed_param_size(mode, I, H, L, ndir)
    arrs = [rs.randn(T, N, I).astype("f"),
            (rs.randn(n) * 0.3).astype("f"),
            (rs.randn(L * ndir, N, H) * 0.5).astype("f")]
    if mode == "lstm":
        arrs.append((rs.randn(L * ndir, N, H) * 0.5).astype("f"))
    if lengths:
        arrs.append(np.array([5, 2, 3], "f"))
    return arrs


def op_cases():
    """(name, inputs, number differentiated, op arguments) of every op
    case: each mode in one and two directions, ragged lengths (GRU in the
    state_cell slot, LSTM after its cell state) and the state clip."""
    cases = []
    for mode in MODES:
        for bi in (False, True):
            arrs = op_inputs(mode, 2 if bi else 1)
            cases.append(("%s-%s" % (mode, bi), arrs, len(arrs), dict(
                mode=mode, state_size=H, num_layers=L, bidirectional=bi,
                state_outputs=True)))
    for mode in ("gru", "lstm"):
        arrs = op_inputs(mode, 2, seed=1, lengths=True)
        cases.append(("len-" + mode, arrs, len(arrs) - 1, dict(
            mode=mode, state_size=H, num_layers=L, bidirectional=True,
            state_outputs=True, use_sequence_length=True)))
    arrs = op_inputs("lstm", 1, seed=2)
    arrs[0] = arrs[0] * 10
    cases.append(("clip", arrs, len(arrs), dict(
        mode="lstm", state_size=H, num_layers=L, state_outputs=True,
        lstm_state_clip_min=-0.1, lstm_state_clip_max=0.1,
        lstm_state_clip_nan=True)))
    return cases


def cotangents(arrs, kw):
    """One numpy cotangent per output of the op."""
    rs = np.random.RandomState(9)
    shapes = [(T, N, H * (2 if kw.get("bidirectional") else 1))] + \
        [arrs[2].shape] * (2 if kw["mode"] == "lstm" else 1)
    return [rs.randn(*s).astype("f") for s in shapes]


@pytest.fixture(scope="module")
def jax_op():
    """{case: (outputs, gradients)} of the JAX op, all cases in one jit:
    the gradients of sum(out_i * cot_i) with respect to the first inputs
    (``jax.vjp``)."""
    cases = op_cases()

    def run(all_arrs):
        res = []
        for (_, _, n_diff, kw), arrs in zip(cases, all_arrs):
            outs, vjp = jax.vjp(
                lambda *d, rest=arrs[n_diff:], kw=kw: jnn.rnn_fused(
                    *d, *rest, **kw), *arrs[:n_diff])
            cots = cotangents(arrs, kw)
            res.append((outs, vjp(tuple(jnp.asarray(c) for c in cots))))
        return res
    out = jax.jit(run)([[jnp.asarray(a) for a in arrs]
                        for _, arrs, _, _ in cases])
    return {c[0]: jax.tree_util.tree_map(np.asarray, r)
            for c, r in zip(cases, out)}


def port_op(arrs, n_diff, kw):
    ts = [torch.tensor(a, requires_grad=i < n_diff)
          for i, a in enumerate(arrs)]
    outs = tnn.rnn_fused(*ts, **kw)
    sum((o * torch.from_numpy(c)).sum()
        for o, c in zip(outs, cotangents(arrs, kw))).backward()
    return [o.detach() for o in outs], [t.grad for t in ts[:n_diff]]


@pytest.mark.parametrize("case", [c[0] for c in op_cases()])
def test_rnn_op_matches_jax(case, jax_op):
    """Outputs and final states within 1e-5, gradients within 1e-4; the
    lengths cases emit zeros past each length; the clip bounds the cell
    state."""
    _, arrs, n_diff, kw = [c for c in op_cases() if c[0] == case][0]
    to, tg = port_op(arrs, n_diff, kw)
    jo, jg = jax_op[case]
    assert len(to) == len(jo) == (3 if kw["mode"] == "lstm" else 2)
    for a, b in zip(to, jo):
        close(a.numpy(), b, FWD)
    for a, b in zip(tg, jg):
        close(a.numpy(), b, GRAD)
    if kw.get("use_sequence_length"):
        assert float(to[0][2:, 1].abs().max()) == 0.0
    if case == "clip":
        assert float(to[2].abs().max()) <= np.float32(0.1)


def test_rnn_packing_and_options():
    for mode in MODES:
        for layers in (1, 3):
            for ndir in (1, 2):
                for isz in (1, 7, 64):
                    n = tnn.rnn_packed_param_size(mode, isz, 5, layers, ndir)
                    assert n == jnn.rnn_packed_param_size(mode, isz, 5,
                                                          layers, ndir)
                    assert tnn.rnn_packed_input_size(
                        n, mode, 5, layers, ndir) == isz
    arrs = [torch.from_numpy(a) for a in op_inputs("gru", 1)]
    with pytest.raises(NotImplementedError):
        tnn.rnn_fused(*arrs, mode="gru", state_size=H, num_layers=L,
                      projection_size=3)
    with pytest.raises(ValueError):
        tnn.rnn_fused(*arrs, mode="gru", state_size=H, num_layers=L,
                      use_sequence_length=True)
    # dropout between the layers: off in predict mode, drawn from the
    # port's generator (or a given one) in training
    kw = dict(mode="gru", state_size=H, num_layers=L, p=0.5)
    plain = tnn.rnn_fused(*arrs, mode="gru", state_size=H, num_layers=L)
    assert torch.equal(tnn.rnn_fused(*arrs, _training=False, **kw), plain)
    a = tnn.rnn_fused(*arrs, key=torch.Generator().manual_seed(3), **kw)
    b = tnn.rnn_fused(*arrs, key=torch.Generator().manual_seed(3), **kw)
    assert torch.equal(a, b) and not torch.equal(a, plain)
    mx.random.seed(4)
    c = tnn.rnn_fused(*arrs, **kw)
    mx.random.seed(4)
    assert torch.equal(c, tnn.rnn_fused(*arrs, **kw))


def test_nd_and_sym_rnn(jax_op):
    arrs = op_inputs("lstm", 2)
    out = mx.nd.RNN(*[mx.nd.array(a) for a in arrs], mode="lstm",
                    state_size=H, num_layers=L, bidirectional=True,
                    state_outputs=True)
    for a, b in zip(out, jax_op["lstm-True"][0]):
        assert isinstance(a, mx.nd.NDArray)
        close(a.asnumpy(), b, FWD)
    with mx.name.NameManager():
        s = mx.sym.RNN(mx.sym.var("data"), mx.sym.var("par"),
                       mx.sym.var("h"), mx.sym.var("c"), mode="lstm",
                       state_size=H, num_layers=L, bidirectional=True,
                       state_outputs=True)
    assert s.list_arguments() == ["data", "par", "h", "c"]
    assert s.infer_shape(data=(T, N, I)) == (
        [(T, N, I), (jnn.rnn_packed_param_size("lstm", I, H, L, 2),),
         (2 * L, N, H), (2 * L, N, H)],
        [(T, N, 2 * H), (2 * L, N, H), (2 * L, N, H)], [])


# -- gluon.rnn --------------------------------------------------------------------

def carry(jnet, net):
    """The JAX block's parameters into the port's, by structural name."""
    convert.load_numpy_params(net, {
        k: p.data().asnumpy()
        for k, p in jnet._collect_params_with_prefix().items()})


def pair(make, jinit=None):
    jnet = make(mxj)
    jnet.initialize(jinit or mxj.init.Uniform(0.3))
    net = make(mx)
    net.initialize()
    carry(jnet, net)
    return jnet, net


@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("cls", ["RNN", "LSTM", "GRU"])
def test_gluon_layer_matches_jax(cls, layout):
    """Without states (zeros; the output alone) and with given states
    (the output and the new states); GRU in both directions."""
    jnet, net = pair(lambda pkg: getattr(pkg.gluon.rnn, cls)(
        H, num_layers=L, layout=layout, bidirectional=cls == "GRU",
        input_size=I, prefix="rnn_"))
    rs = np.random.RandomState(1)
    x = rs.randn(*((T, N, I) if layout == "TNC" else (N, T, I))).astype("f")
    close(net(mx.nd.array(x)).asnumpy(), jnet(mxj.nd.array(x)).asnumpy(),
          FWD)
    ndir = 2 if cls == "GRU" else 1
    st = [(rs.randn(L * ndir, N, H) * 0.5).astype("f")
          for _ in range(2 if cls == "LSTM" else 1)]
    jo, js = jnet(mxj.nd.array(x), [mxj.nd.array(s) for s in st])
    with mx.autograd.record():
        to, ts = net(mx.nd.array(x), [mx.nd.array(s) for s in st])
        loss = (to * to).sum() + sum((s * s).sum() for s in ts)
    loss.backward()
    close(to.asnumpy(), jo.asnumpy(), FWD)
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        close(a.asnumpy(), b.asnumpy(), FWD)
    for p in net.collect_params().values():
        assert float(np.abs(p.grad().asnumpy()).max()) > 0


def test_gluon_layer_deferred_states_and_errors():
    jnet, net = pair(lambda pkg: pkg.gluon.rnn.LSTM(H, input_size=I))
    with pytest.raises(ValueError):
        net(mx.nd.zeros((T, N, I)), [mx.nd.zeros((1, N + 1, H))] * 2)
    st = net.begin_state(batch_size=N)
    assert [s.shape for s in st] == [(1, N, H)] * 2
    assert isinstance(st[0], mx.nd.NDArray)
    deferred = mx.gluon.rnn.GRU(H, num_layers=2)
    deferred.initialize()
    deferred(mx.nd.zeros((T, N, 7)))
    assert deferred.l0_i2h_weight.shape == (3 * H, 7)
    assert deferred.l1_i2h_weight.shape == (3 * H, H)
    assert "LSTM(4 -> 6, TNC)" in repr(net)


def test_unfuse_matches_the_fused_layer():
    net = mx.gluon.rnn.LSTM(H, num_layers=L, input_size=I, prefix="lstm_")
    net.initialize(mx.init.Uniform(0.3))
    stack = net.unfuse()
    stack.initialize()
    fused = {p.name: p for p in net.collect_params().values()}
    for name, p in stack.collect_params().items():
        p.set_data(fused[name].data())
    x = mx.nd.array(np.random.RandomState(2).randn(T, N, I).astype("f"))
    out, _ = stack.unroll(T, x, layout="TNC", merge_outputs=True)
    close(out.asnumpy(), net(x).asnumpy(), FWD)


CELLS = [("RNNCell", {"activation": "relu"}), ("LSTMCell", {}),
         ("GRUCell", {})]


@pytest.mark.parametrize("cls,kw", CELLS)
def test_cell_unroll_valid_length(cls, kw):
    jc, tc = pair(lambda pkg: getattr(pkg.gluon.rnn, cls)(
        H, input_size=I, prefix="c_", **kw))
    rs = np.random.RandomState(3)
    x = rs.randn(N, T, I).astype("f")
    vl = np.array([5, 2, 3], "f")
    jo, js = jc.unroll(T, mxj.nd.array(x), merge_outputs=True,
                       valid_length=mxj.nd.array(vl))
    to, ts = tc.unroll(T, mx.nd.array(x), merge_outputs=True,
                       valid_length=mx.nd.array(vl))
    close(to.asnumpy(), jo.asnumpy(), FWD)
    for a, b in zip(ts, js):
        close(a.asnumpy(), b.asnumpy(), FWD)
    # one step of the cell on tensors gives tensors
    out, states = tc(torch.from_numpy(x[:, 0]), [torch.zeros(N, H)] *
                     len(tc.state_info()))
    assert isinstance(out, torch.Tensor)
    assert all(isinstance(s, torch.Tensor) for s in states)


def test_stacked_modifier_and_bidirectional_cells():
    """A stack of an LSTM, a dropout, a residual GRU and a zoneout RNN
    cell (predict mode: the masks keep everything), and a bidirectional
    cell over ragged lengths."""
    def stack(pkg):
        r = pkg.gluon.rnn
        s = r.HybridSequentialRNNCell(prefix="s_")
        with s.name_scope():
            s.add(r.LSTMCell(H, input_size=I))
            s.add(r.DropoutCell(0.5))
            s.add(r.ResidualCell(r.GRUCell(H, input_size=H)))
            s.add(r.ZoneoutCell(r.RNNCell(H, input_size=H), 0.5, 0.5))
        return s

    def bi(pkg):
        r = pkg.gluon.rnn
        return r.BidirectionalCell(r.LSTMCell(H, input_size=I, prefix="l_"),
                                   r.GRUCell(H, input_size=I, prefix="r_"))
    rs = np.random.RandomState(4)
    x = rs.randn(N, T, I).astype("f")
    vl = np.array([5, 1, 4], "f")
    for make, lens in ((stack, None), (bi, vl)):
        jc, tc = pair(make)
        kw = {} if lens is None else {"valid_length": lens}
        jo, js = jc.unroll(T, mxj.nd.array(x), merge_outputs=True,
                           **{k: mxj.nd.array(v) for k, v in kw.items()})
        to, ts = tc.unroll(T, mx.nd.array(x), merge_outputs=True,
                           **{k: mx.nd.array(v) for k, v in kw.items()})
        close(to.asnumpy(), jo.asnumpy(), FWD)
        assert len(ts) == len(js)
        for a, b in zip(ts, js):
            close(a.asnumpy(), b.asnumpy(), FWD)
    with pytest.raises(NotImplementedError):
        tc(mx.nd.array(x[:, 0]), tc.begin_state(batch_size=N))


# -- gluon.contrib.rnn --------------------------------------------------------------

def test_contrib_lstmp_and_variational_dropout():
    def lstmp(pkg):
        return pkg.gluon.contrib.rnn.LSTMPCell(H, 3, input_size=I,
                                               prefix="p_")

    def vardrop(pkg):
        return pkg.gluon.contrib.rnn.VariationalDropoutCell(
            pkg.gluon.rnn.GRUCell(H, input_size=I, prefix="g_"),
            drop_inputs=0.3, drop_states=0.3, drop_outputs=0.3)
    x = np.random.RandomState(5).randn(N, T, I).astype("f")
    for make in (lstmp, vardrop):
        jc, tc = pair(make)
        jo, js = jc.unroll(T, mxj.nd.array(x), merge_outputs=True)
        to, ts = tc.unroll(T, mx.nd.array(x), merge_outputs=True)
        close(to.asnumpy(), jo.asnumpy(), FWD)
        for a, b in zip(ts, js):
            close(a.asnumpy(), b.asnumpy(), FWD)
    # in training the three masks are drawn once per unroll
    with mx.autograd.record():
        a, _ = tc.unroll(T, mx.nd.array(x), merge_outputs=True)
    assert tc.drop_inputs_mask is not None
    assert a.shape == (N, T, H)


def test_contrib_conv_cells():
    """Conv2DLSTMCell unrolled 4 steps against JAX's (1e-4: the
    convolutions sum in another order); the 1-D GRU and 3-D RNN cells'
    shapes."""
    def make(pkg):
        return pkg.gluon.contrib.rnn.Conv2DLSTMCell(
            (2, 6, 5), 3, i2h_kernel=3, h2h_kernel=3, i2h_pad=1,
            prefix="cv_")
    jc, tc = pair(make)
    x = np.random.RandomState(6).randn(2, 4, 2, 6, 5).astype("f")
    jo, js = jc.unroll(4, mxj.nd.array(x), merge_outputs=True)
    to, ts = tc.unroll(4, mx.nd.array(x), merge_outputs=True)
    close(to.asnumpy(), jo.asnumpy(), CONV)
    for a, b in zip(ts, js):
        close(a.asnumpy(), b.asnumpy(), CONV)
    for cls, spatial, n_states in (("Conv1DGRUCell", (7,), 1),
                                   ("Conv3DRNNCell", (3, 4, 5), 1)):
        cell = getattr(mx.gluon.contrib.rnn, cls)(
            (2,) + spatial, 3, i2h_kernel=3, h2h_kernel=1)
        cell.initialize()
        out, states = cell.unroll(2, mx.nd.ones((2, 2, 2) + spatial),
                                  merge_outputs=True)
        assert out.shape == (2, 2, 3) + tuple(s - 2 for s in spatial)
        assert len(states) == n_states

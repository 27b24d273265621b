"""The port's legacy ``mx.rnn`` held against the JAX package's on the CPU,
f32, from the same numpy values.

- The stepwise cells unrolled into symbols (RNN, LSTM, GRU, dropout,
  residual, zoneout, bidirectional; the convolutional cells): the same
  graph JSON under one NameManager, and the bound forward within 1e-5 of
  the largest output (1e-4 for the convolutions, which sum in another
  order).
- ``pack_weights``/``unpack_weights``: the same per-gate arrays as JAX's,
  bit for bit, and back.
- ``FusedRNNCell`` against its ``unfuse()`` stack (1e-5) and against
  JAX's fused cell; ``init.FusedRNN``'s packed vector equal to JAX's.
- ``encode_sentences``; ``BucketSentenceIter``'s batches, bucket keys and
  descriptors under the same Python and numpy seeds, equal to JAX's.
- ``save_rnn_checkpoint``/``load_rnn_checkpoint``/``do_rnn_checkpoint``:
  the files byte for byte and loaded across the packages.
- A ``BucketingModule`` LM (``example/rnn/lstm_bucketing.py``'s
  structure, narrow): the first forward on two bucket keys within 1e-5.
"""
import os
import random

import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx

FWD = 1e-5
CONV = 1e-4
N, T, I, H = 2, 4, 3, 5


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


def both(build):
    """``build(pkg)`` in each package under a NameManager: (JAX's, the
    port's)."""
    out = []
    for pkg in (mxj, mx):
        with pkg.name.NameManager():
            out.append(build(pkg))
    return out


def forward(pkg, sym, shapes, seed=7):
    """Bind ``sym`` with every argument drawn from a seed (the inputs of
    ``shapes`` from normals, the rest uniform in [-0.3, 0.3)) and run one
    forward: numpy outputs and the arguments."""
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    args = {}
    for name, shp in zip(sym.list_arguments(), arg_shapes):
        args[name] = rs.randn(*shp).astype("f") if name in shapes else \
            (rs.rand(*shp) * 0.6 - 0.3).astype("f")
    ctx = pkg.cpu()
    exe = sym.bind(ctx, {k: pkg.nd.array(v, ctx=ctx)
                         for k, v in args.items()})
    return [o.asnumpy() for o in exe.forward()], args


def test_stepwise_cells_match_jax():
    def build(pkg):
        r = pkg.rnn
        data = pkg.sym.var("data")
        stack = r.SequentialRNNCell()
        stack.add(r.RNNCell(H, prefix="a_"))
        stack.add(r.LSTMCell(H, prefix="b_"))
        stack.add(r.DropoutCell(0.5, prefix="d_"))
        stack.add(r.GRUCell(H, prefix="c_"))
        stack.add(r.ResidualCell(r.LSTMCell(H, prefix="e_")))
        stack.add(r.ZoneoutCell(r.RNNCell(H, activation="relu",
                                          prefix="f_"), 0.5, 0.5))
        out, states = stack.unroll(T, inputs=data, merge_outputs=True)
        bi = r.BidirectionalCell(r.LSTMCell(H, prefix="l_"),
                                 r.GRUCell(H, prefix="r_"))
        bout, bstates = bi.unroll(T, inputs=data, merge_outputs=True)
        assert len(states) == 7 and len(bstates) == 2
        return pkg.sym.Group([out, bout] + states)
    jsym, tsym = both(build)
    assert tsym.tojson() == jsym.tojson()
    jo, args = forward(mxj, jsym, {"data": (N, T, I)})
    to, _ = forward(mx, tsym, {"data": (N, T, I)})
    assert to[1].shape == (N, T, 2 * H)
    for a, b in zip(to, jo):
        close(a, b, FWD)


def test_conv_cells_match_jax():
    def build(pkg):
        r = pkg.rnn
        data = pkg.sym.var("data")
        outs = []
        for klass, name in ((r.ConvRNNCell, "cr_"), (r.ConvLSTMCell, "cl_"),
                            (r.ConvGRUCell, "cg_")):
            cell = klass(input_shape=(N, 3, 6, 6), num_hidden=4,
                         prefix=name)
            o, _ = cell.unroll(2, inputs=data, merge_outputs=False)
            outs.append(o[-1])
        return pkg.sym.Group(outs)
    jsym, tsym = both(build)
    jo, _ = forward(mxj, jsym, {"data": (N, 2, 3, 6, 6)})
    to, _ = forward(mx, tsym, {"data": (N, 2, 3, 6, 6)})
    for a, b in zip(to, jo):
        assert a.shape == (N, 4, 6, 6)
        close(a, b, CONV)


def fused_cell(pkg, mode="lstm", bidirectional=True):
    return pkg.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                                bidirectional=bidirectional, prefix="f_")


def test_pack_unpack_match_jax():
    rs = np.random.RandomState(0)
    for make, arrays in (
            (lambda pkg: pkg.rnn.LSTMCell(H, prefix="x_"),
             {"x_i2h_weight": (4 * H, I), "x_i2h_bias": (4 * H,),
              "x_h2h_weight": (4 * H, H), "x_h2h_bias": (4 * H,),
              "other": (2,)}),
            (lambda pkg: pkg.rnn.GRUCell(H, prefix="g_"),
             {"g_i2h_weight": (3 * H, I), "g_i2h_bias": (3 * H,),
              "g_h2h_weight": (3 * H, H), "g_h2h_bias": (3 * H,)}),
            (fused_cell, {"f_parameters": (mxj.ops.nn.rnn_packed_param_size(
                "lstm", I, H, 2, 2),)})):
        vals = {k: rs.randn(*s).astype("f") for k, s in arrays.items()}
        jcell, tcell = make(mxj), make(mx)
        jun = jcell.unpack_weights({k: mxj.nd.array(v)
                                    for k, v in vals.items()})
        tun = tcell.unpack_weights({k: mx.nd.array(v)
                                    for k, v in vals.items()})
        assert sorted(tun) == sorted(jun)
        for k in jun:
            assert np.array_equal(tun[k].asnumpy(), jun[k].asnumpy()), k
        back = tcell.pack_weights(tun)
        assert sorted(back) == sorted(vals)
        for k, v in vals.items():
            assert np.array_equal(back[k].asnumpy(), v), k


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
def test_fused_cell_matches_unfuse(mode):
    """The fused cell's one RNN node against its stack of stepwise cells
    given the same weights through unpack_weights/pack_weights; the
    bidirectional LSTM also against JAX's fused cell."""
    bi = mode == "lstm"
    with mx.name.NameManager():
        fused = fused_cell(mx, mode, bi)
        fo, _ = fused.unroll(T, inputs=mx.sym.var("data"),
                             merge_outputs=True)
        stack = fused.unfuse()
        so, _ = stack.unroll(T, inputs=mx.sym.var("data"),
                             merge_outputs=True)
    y_fused, args = forward(mx, fo, {"data": (N, T, I)})
    per_layer = stack.pack_weights(fused.unpack_weights(
        {"f_parameters": mx.nd.array(args["f_parameters"])}))
    x = args["data"]
    exe = so.bind(mx.cpu(), dict(per_layer, data=mx.nd.array(x)))
    close(exe.forward()[0].asnumpy(), y_fused[0], FWD)
    if bi:
        with mxj.name.NameManager():
            jfo, _ = fused_cell(mxj, mode, bi).unroll(
                T, inputs=mxj.sym.var("data"), merge_outputs=True)
        jy, _ = forward(mxj, jfo, {"data": (N, T, I)})
        close(y_fused[0], jy[0], FWD)


def test_init_fused_rnn_matches_jax():
    """init.FusedRNN walks the packed vector as JAX's does: the inner
    initializer on each gate block, LSTM forget-gate biases 1."""
    n = mxj.ops.nn.rnn_packed_param_size("lstm", I, H, 2, 2)
    vecs = []
    for pkg in (mxj, mx):
        init = pkg.init.FusedRNN(pkg.init.Constant(0.25), H, 2, "lstm",
                                 True, forget_bias=1.0)
        arr = pkg.nd.zeros((n,))
        init(pkg.init.InitDesc("f_parameters"), arr)
        vecs.append(arr.asnumpy())
    assert np.array_equal(vecs[1], vecs[0])
    # through a Module bind, with a random inner initializer
    with mx.name.NameManager():
        fo, _ = fused_cell(mx).unroll(2, inputs=mx.sym.var("data"),
                                      merge_outputs=True)
    mod = mx.mod.Module(fo, data_names=("data",), label_names=None,
                        context=mx.cpu())
    mod.bind(data_shapes=[("data", (N, 2, I))])
    mod.init_params(initializer=mx.init.Uniform(0.1))
    un = fused_cell(mx).unpack_weights(mod.get_params()[0])
    assert np.array_equal(un["f_l0_i2h_f_bias"].asnumpy(), np.ones(H, "f"))
    assert np.array_equal(un["f_r1_h2h_f_bias"].asnumpy(), np.ones(H, "f"))
    assert np.array_equal(un["f_l0_i2h_i_bias"].asnumpy(), np.zeros(H, "f"))
    assert un["f_l0_i2h_i_weight"].asnumpy().std() > 0


def test_encode_sentences_matches_jax():
    sents = [["a", "b", "c"], ["b", "c", "d"], ["e"]]
    for kw in ({}, {"start_label": 1, "invalid_label": 0},
               {"vocab": {"\n": 0, "a": 1, "b": 2}, "unknown_token": "<u>",
                "start_label": 3}):
        kw_j = {k: (dict(v) if isinstance(v, dict) else v)
                for k, v in kw.items()}
        assert mx.rnn.encode_sentences(sents, **kw) == \
            mxj.rnn.encode_sentences(sents, **kw_j)
    with pytest.raises(AssertionError):
        mx.rnn.encode_sentences(sents, vocab={"a": 1})


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_matches_jax(layout):
    rs = np.random.RandomState(0)
    sents = [list(rs.randint(1, 20, size=n))
             for n in rs.randint(3, 12, size=70)]
    runs = []
    for pkg in (mxj, mx):
        random.seed(5)
        np.random.seed(5)
        it = pkg.rnn.BucketSentenceIter(sents, batch_size=4,
                                        buckets=[4, 8, 10], invalid_label=0,
                                        layout=layout)
        batches = []
        for _ in range(2):
            it.reset()
            batches += [(b.bucket_key, b.data[0].asnumpy(),
                         b.label[0].asnumpy(), b.provide_data[0].shape,
                         b.provide_label[0].layout) for b in it]
        runs.append((it.buckets, it.default_bucket_key,
                     [tuple(d.shape) for d in it.provide_data], batches))
    (jb, jk, jd, jbat), (tb, tk, td, tbat) = runs
    assert (tb, tk, td) == (jb, jk, jd)
    assert len(tbat) == len(jbat) > 0
    for a, b in zip(tbat, jbat):
        assert a[0] == b[0] and a[3:] == b[3:]
        assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
        assert a[1].shape == ((4, a[0]) if layout == "NT" else (a[0], 4))


def test_rnn_checkpoint_across_packages(tmp_path):
    def build(pkg):
        cell = fused_cell(pkg)
        out, _ = cell.unroll(2, inputs=pkg.sym.var("data"),
                             merge_outputs=True)
        return cell, out
    (jcell, jout), (tcell, tout) = both(build)
    n = mxj.ops.nn.rnn_packed_param_size("lstm", I, H, 2, 2)
    vec = np.random.RandomState(1).randn(n).astype("f")
    jprefix, tprefix = str(tmp_path / "jax"), str(tmp_path / "port")
    mxj.rnn.save_rnn_checkpoint(jcell, jprefix, 3, jout,
                                {"f_parameters": mxj.nd.array(vec)}, {})
    mx.rnn.save_rnn_checkpoint(tcell, tprefix, 3, tout,
                               {"f_parameters": mx.nd.array(vec)}, {})
    for suffix in ("-symbol.json", "-0003.params"):
        with open(jprefix + suffix, "rb") as f:
            want = f.read()
        with open(tprefix + suffix, "rb") as f:
            assert f.read() == want, suffix
    _, raw, _ = mx.model.load_checkpoint(tprefix, 3)
    assert "f_r1_h2h_o_weight" in raw and "f_parameters" not in raw
    for pkg, cell, prefix in ((mx, tcell, jprefix), (mxj, jcell, tprefix)):
        sym, arg, aux = pkg.rnn.load_rnn_checkpoint(cell, prefix, 3)
        assert np.array_equal(arg["f_parameters"].asnumpy(), vec)
        assert aux == {} and sym.list_arguments() == tout.list_arguments()
    cb = mx.rnn.do_rnn_checkpoint(tcell, str(tmp_path / "cb"), period=2)
    cb(0, tout, {"f_parameters": mx.nd.array(vec)}, {})
    cb(1, tout, {"f_parameters": mx.nd.array(vec)}, {})
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["jax-symbol.json", "jax-0003.params", "port-symbol.json",
         "port-0003.params", "cb-symbol.json", "cb-0002.params"])
    with pytest.warns(UserWarning):
        outs, _ = mx.rnn.rnn_unroll(mx.rnn.LSTMCell(H, prefix="u_"), 2,
                                    inputs=mx.sym.var("data"))
    assert len(outs) == 2


def lm_sym_gen(pkg, vocab, emb, hid):
    stack = pkg.rnn.SequentialRNNCell()
    stack.add(pkg.rnn.LSTMCell(hid, prefix="lstm_l0_"))
    stack.add(pkg.rnn.LSTMCell(hid, prefix="lstm_l1_"))

    def sym_gen(seq_len):
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        embed = pkg.sym.Embedding(data=data, input_dim=vocab,
                                  output_dim=emb, name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = pkg.sym.Reshape(outputs, shape=(-1, hid))
        pred = pkg.sym.FullyConnected(data=pred, num_hidden=vocab,
                                      name="pred")
        label = pkg.sym.Reshape(label, shape=(-1,))
        pred = pkg.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def test_bucketing_module_first_forward_matches_jax():
    vocab, emb, hid, batch = 20, 6, 8, 4
    rs = np.random.RandomState(2)
    sents = [list(rs.randint(1, vocab, size=n))
             for n in rs.randint(3, 9, size=40)]
    outs = []
    for pkg in (mxj, mx):
        random.seed(1)
        np.random.seed(1)
        it = pkg.rnn.BucketSentenceIter(sents, batch, buckets=[4, 8],
                                        invalid_label=0)
        mod = pkg.mod.BucketingModule(
            lm_sym_gen(pkg, vocab, emb, hid),
            default_bucket_key=it.default_bucket_key, context=pkg.cpu())
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(initializer=pkg.init.Zero())
        if not outs:
            wrs = np.random.RandomState(3)
            params = {k: (wrs.rand(*v.shape) * 0.4 - 0.2).astype("f")
                      for k, v in sorted(mod.get_params()[0].items())}
        mod.set_params({k: pkg.nd.array(v) for k, v in params.items()}, {})
        got = {}
        for b in it:
            if b.bucket_key not in got:
                mod.forward(b, is_train=False)
                got[b.bucket_key] = mod.get_outputs()[0].asnumpy()
        outs.append(got)
    assert sorted(outs[1]) == sorted(outs[0]) == [4, 8]
    for k in outs[0]:
        close(outs[1][k], outs[0][k], FWD)

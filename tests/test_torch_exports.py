"""The port exports the JAX package's public names.

For every module that both packages have (by path under the package),
each name in the JAX module's ``__all__`` must exist in the port's
module, except the names below: the JAX-only names the port does not
carry (non-goals) and the names of slices not ported yet. The names the
JAX package exports from modules without an ``__all__`` (the package
root, ``gluon``, the ResNet zoo module, ``image_det``) are listed too.
"""
import importlib
import os

import pytest

import mxnet_tpu
import mxnet_tpu_torch

# JAX-only names (non-goals): the dispatch cache and bulk segments, the
# key functions of the threefry random stream, the TPU contexts, the pure
# forward that JAX's jit traces.
NON_GOALS = {
    "context": {"tpu", "num_tpus"},
    "gluon.block": {"make_pure_forward"},
    "ndarray.register": {"make_op_func", "imperative_jit_enabled",
                         "set_imperative_jit", "flush_bulk_segment",
                         "bulk_segment_depth", "aval",
                         "register_signature_token", "signature_tokens",
                         "signature_token_names"},
    "random": {"next_key", "current_key", "push_trace_key",
               "pop_trace_key"},
}

# Names of slices still to port: M10b (the asynchronous parameter server
# and elastic training), M10c (the LM's parallel modes), M11-S (sparse and
# NumPy arrays), M11-O (registry names), M11-X (the native runtime).
NOT_YET = {
    "parallel": {"ring_self_attention",
                 "ulysses_attention", "pipeline_stages", "PipelineStage",
                 "MoELayer", "top_k_routing", "elastic_train_loop",
                 "PreemptionGuard", "ElasticController", "HostGradReducer"},
    "parallel.elastic": {"elastic_train_loop", "PreemptionGuard",
                         "ElasticController", "HostGradReducer",
                         "publish_peer_snapshot", "restore_from_peer"},
    "parallel.ring_attention": {"ring_attention", "ring_self_attention"},
    "parallel.transformer": {"param_specs"},
    "ndarray.contrib": {"arange_like"},
    "symbol.contrib": {"index_copy"},
    "symbol.linalg": {"extracttrian", "maketrian", "syevd"},
    "recordio": {"ThreadedRecordReader"},
}

# Modules without an __all__ in the JAX package, and what they export.
NO_ALL = {
    "": ["set_matmul_precision", "get_matmul_precision", "matmul_precision",
         "rnn", "AttrScope", "Context", "cpu", "gpu", "cpu_pinned",
         "current_context", "num_gpus", "NDArray", "nd", "seed", "waitall"],
    "gluon": ["FusedTrainStep", "train_step", "Parameter", "Constant",
              "ParameterDict", "Block", "HybridBlock", "SymbolBlock",
              "Trainer", "rnn", "contrib", "nn", "loss", "utils"],
    "gluon.model_zoo.vision.resnet": ["resnet_net_versions",
                                      "resnet_block_versions"],
    "image_det": ["LightingAug", "imresize"],
}


def _modules(pkg):
    root = os.path.dirname(pkg.__file__)
    out = set()
    for dirpath, _, files in os.walk(root):
        if "__pycache__" in dirpath:
            continue
        rel = os.path.relpath(dirpath, root)
        parts = [] if rel == "." else rel.split(os.sep)
        for f in files:
            if f.endswith(".py"):
                name = parts + ([] if f == "__init__.py" else [f[:-3]])
                out.add(".".join(name))
    return out


SHARED = sorted(_modules(mxnet_tpu) & _modules(mxnet_tpu_torch))


def _import(pkg, rel):
    return importlib.import_module(pkg.__name__ + ("." + rel if rel else ""))


def test_shared_modules_are_found():
    for rel in ("", "ops.nn", "ops.misc_tail", "rnn.rnn_cell",
                "gluon.rnn.rnn_layer", "gluon.contrib.rnn.conv_rnn_cell"):
        assert rel in SHARED, rel


@pytest.mark.parametrize("rel", SHARED)
def test_port_exports_the_jax_names(rel):
    jmod = _import(mxnet_tpu, rel)
    tmod = _import(mxnet_tpu_torch, rel)
    names = list(getattr(jmod, "__all__", ())) + NO_ALL.get(rel, [])
    skip = NON_GOALS.get(rel, set()) | NOT_YET.get(rel, set())
    missing = [n for n in names if n not in skip and not hasattr(tmod, n)]
    assert not missing, missing
    # an excepted name that the port has now leaves the list
    assert not [n for n in skip if hasattr(tmod, n)]


def test_the_port_has_the_rnn_names():
    import mxnet_tpu_torch as mx
    for name in ("RNN", "rnn", "_rnn_param_concat", "hawkesll",
                 "count_sketch", "index_array", "hanning", "hamming",
                 "blackman", "IdentityAttachKLSparseReg"):
        assert name in mx.ops.list_ops(), name
        assert hasattr(mx.nd, name) and hasattr(mx.sym, name)
    assert mx.rnn.BucketSentenceIter and mx.gluon.rnn.LSTM
    assert mx.gluon.contrib.rnn.Conv2DLSTMCell
    assert len(set(mx.ops.list_ops()) & set(mxnet_tpu.ops.list_ops())) \
        >= 430 + 17

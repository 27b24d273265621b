"""The port's ResNet V1 serving slice held against the JAX package, and the
port's ground rules (no JAX import, card by default, strict weight carry).

Both networks get the same weights: numpy arrays drawn from a seed,
keyed by the structural parameter names both packages produce, loaded
into the JAX net with ``Parameter.set_data`` and into the port with
``convert.load_numpy_params``. The weights are He-scaled with non-trivial
running statistics so the logits are O(1) (the default Uniform(0.07)
init gives logits of ~1e-4 at this width, which would make any tolerance
empty). Eval-mode logits must agree to 1e-4 of their largest magnitude.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.kernels import conv_fused as CF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = {"bottleneck": ([1, 1, 1, 1], [16, 32, 64, 128, 256]),
          "basic": ([1, 1, 1, 1], [16, 16, 32, 64, 128])}


def _jax_net(kind, fuse, x):
    layers, channels = NARROW[kind]
    block = jres.BottleneckV1 if kind == "bottleneck" else jres.BasicBlockV1
    net = jres.ResNetV1(block, layers, channels, classes=10, thumbnail=True,
                        layout="NHWC", fuse=fuse)
    net.initialize()
    net(mxj.nd.array(np.zeros_like(x)))
    return net


def _port_net(kind, fuse):
    layers, channels = NARROW[kind]
    block = tres.BottleneckV1 if kind == "bottleneck" else tres.BasicBlockV1
    net = tres.ResNetV1(block, layers, channels, classes=10, thumbnail=True,
                        layout="NHWC", fuse=fuse)
    net.initialize(ctx=mx.cpu())
    return net


@pytest.mark.parametrize("kind,fuse", [("bottleneck", True),
                                       ("bottleneck", False),
                                       ("basic", True)])
def test_narrow_resnet_matches_jax(kind, fuse, monkeypatch):
    x = np.random.RandomState(7).rand(2, 3, 32, 32).astype("float32")
    jnet = _jax_net(kind, fuse, x)
    jparams = jnet._collect_params_with_prefix()
    arrays = convert.random_numpy_params(
        {k: p.shape for k, p in jparams.items()}, seed=3)
    for k, p in jparams.items():
        p.set_data(mxj.nd.array(arrays[k]))
    ref = jnet(mxj.nd.array(x)).asnumpy()

    net = _port_net(kind, fuse)
    convert.load_numpy_params(net, arrays)      # deferred params take shape
    calls = []
    plain = CF.fused_conv_reference
    monkeypatch.setattr(CF, "fused_conv_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    before = CF.LAUNCHES
    out = net(torch.from_numpy(x))
    # a CPU tensor takes the plain version: once per block when fused
    assert len(calls) == (4 if fuse else 0)
    assert CF.LAUNCHES == before
    assert tuple(out.shape) == ref.shape == (2, 10)
    scale = np.abs(ref).max()
    assert scale > 0.1, scale          # the weights give O(1) logits
    assert np.abs(out.numpy() - ref).max() <= 1e-4 * scale


def test_resnet50_structural_keys_and_shapes_match_jax():
    """Full width: same structural keys and shapes as the JAX net, and
    the port's state_dict uses those keys."""
    x = np.zeros((1, 3, 32, 32), "float32")
    jnet = jres.resnet50_v1(layout="NHWC", fuse=True)
    jnet.initialize()
    jnet.infer_shape(mxj.nd.array(x))       # abstract forward: shapes only
    net = tres.resnet50_v1(layout="NHWC", fuse=True)
    net.initialize(ctx=mx.cpu())
    net(torch.from_numpy(x))
    jshapes = {k: tuple(p.shape)
               for k, p in jnet._collect_params_with_prefix().items()}
    assert convert.param_shapes(net) == jshapes
    assert set(net.state_dict()) == set(jshapes)
    running = [k for k in jshapes if k.endswith("running_var")]
    assert len(running) == 53
    assert all(k in dict(net.named_buffers()) for k in running)


def test_fuse_auto_policy_matches_jax():
    def flags(net):
        return [blk._fuse for stage in list(net.features)[4:8]
                for blk in stage]
    for fuse in ("auto", True, False):
        assert flags(tres.resnet50_v1(layout="NHWC", fuse=fuse)) == \
            flags(jres.resnet50_v1(layout="NHWC", fuse=fuse))
    with pytest.raises(ValueError):
        tres.resnet50_v1(layout="NCHW", fuse=True)


def test_bf16_fused_matches_unfused():
    """Cast to bf16 (running statistics included): the fused link rounds
    the activation in bf16, the unfused one in the BN op's f32 chain, so
    the two agree to a few bf16 steps of the logit scale."""
    x = np.random.RandomState(8).rand(2, 3, 32, 32).astype("float32")
    nets = [_port_net("bottleneck", f) for f in (True, False)]
    nets[0](torch.from_numpy(x))
    arrays = convert.random_numpy_params(convert.param_shapes(nets[0]),
                                         seed=4)
    outs = []
    for net in nets:
        convert.load_numpy_params(net, arrays)
        net.cast("bfloat16")
        assert net.features[1][0].body[1].running_var._tensor().dtype == \
            torch.bfloat16
        outs.append(net(torch.from_numpy(x).bfloat16()).float())
    assert outs[0].dtype == torch.float32
    scale = outs[1].abs().max().item()
    assert (outs[0] - outs[1]).abs().max().item() <= 3e-2 * scale


@pytest.mark.parametrize("case", ["missing", "extra", "shape"])
def test_load_numpy_params_is_strict(case):
    net = _port_net("basic", False)
    net(torch.zeros(1, 3, 8, 8))
    arrays = convert.random_numpy_params(convert.param_shapes(net))
    key = "features.1.0.body.0.weight"
    before = net.features[1][0].body[0].weight._tensor().clone()
    if case == "missing":
        del arrays[key]
        err = KeyError
    elif case == "extra":
        arrays["features.9.weight"] = np.zeros(3, "float32")
        err = KeyError
    else:
        arrays[key] = np.zeros((16, 16, 1, 3), "float32")
        err = ValueError
    with pytest.raises(err):
        convert.load_numpy_params(net, arrays)
    assert torch.equal(net.features[1][0].body[0].weight._tensor(), before)


def test_block_surface():
    net = _port_net("basic", True)
    net.hybridize()                       # accepted; runs eagerly
    x = torch.rand(1, 3, 8, 8)
    out = net(x)
    assert not out.requires_grad
    params = net.collect_params()
    assert len(params) == len(net._collect_params_with_prefix())
    assert all(name.startswith(net.prefix) for name in params.keys())
    weight = net.features[0].weight
    assert isinstance(weight._tensor(), torch.nn.Parameter)
    bn = net.features[1][0].body[1]
    assert not isinstance(bn.running_mean._tensor(), torch.nn.Parameter)
    nets = []
    for _ in range(2):          # the seed fixes the deferred draws too
        mx.random.seed(5)
        nets.append(_port_net("basic", True))
        nets[-1](x)
    w1, w2 = nets
    assert torch.equal(w1.features[0].weight._tensor(),
                       w2.features[0].weight._tensor())


def test_entry_points_default_to_the_card():
    """With no CUDA device, an entry point given no context raises
    instead of running on the CPU; an explicit CPU context works."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(mx.MXNetError):
        mx.current_context()
    with pytest.raises(mx.MXNetError):
        tres.resnet18_v1(layout="NHWC").initialize()
    with pytest.raises(mx.MXNetError):
        mx.gpu(0).device
    with mx.cpu():
        assert mx.current_context() == mx.cpu()
        tres.resnet18_v1().initialize()


def test_import_leaves_jax_out():
    code = ("import sys; sys.path.insert(0, %r); import mxnet_tpu_torch, "
            "chip_smoke, chip_f32_witness, chip_flash_probe, chip_conv_probe, "
            "chip_bn_probe, chip_qmm_probe, chip_codec_probe, "
            "chip_profile_probe, chip_rec_probe; "
            "bad = [m for m in sys.modules if m.split('.')[0] "
            "in ('jax', 'jaxlib', 'mxnet_tpu', 'cv2')]; print(bad); "
            "sys.exit(1 if bad else 0)" % REPO)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _port_sources():
    pkg = os.path.join(REPO, "mxnet_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "chip_f32_witness.py")
    yield os.path.join(REPO, "chip_flash_probe.py")
    yield os.path.join(REPO, "chip_conv_probe.py")
    yield os.path.join(REPO, "chip_bn_probe.py")
    yield os.path.join(REPO, "chip_qmm_probe.py")
    yield os.path.join(REPO, "chip_codec_probe.py")
    yield os.path.join(REPO, "chip_profile_probe.py")
    yield os.path.join(REPO, "chip_rec_probe.py")


def test_no_jax_or_reference_imports_in_port_sources():
    """No source imports JAX or the JAX package; OpenCV is imported in one
    place, inside the function ``base.cv2`` (never at import time)."""
    found = []
    helper = os.path.join(REPO, "mxnet_tpu_torch", "base.py")
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        inside = set()
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef) and path == helper \
                    and fn.name == "cv2":
                inside.update(id(n) for n in ast.walk(fn))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "mxnet_tpu") or (
                        top == "cv2" and id(node) not in inside):
                    found.append((os.path.relpath(path, REPO), name))
    assert found == []

"""The port's persistent compile cache (mxnet_tpu_torch/gluon/compile_cache.py)
over the kernels' shared libraries, on a fake artifact: a shared library
the host already has stands in for a built kernel, so no nvcc is needed.

The counters (hits, misses, stores, deserialize_errors, store_errors) in
metrics()['compile_cache'], publication by temp write + rename, and the
contract of kernels/_build.py: with MXTPU_COMPILE_CACHE_DIR set a warm
entry is loaded and nothing is built; a torn entry is counted, removed and
built again from the same source -- never a fallback, so a missing nvcc
still raises.
"""
import _ctypes
import ctypes
import os
import shutil

import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import compile_cache as cc
from mxnet_tpu_torch.kernels import _build

FAKE = _ctypes.__file__     # a loadable shared library
KEY = ("libfake-0123.so", "Cuda compilation tools, release 12.8",
       "12.8", (9, 0))


@pytest.fixture
def cache(monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_COMPILE_CACHE_DIR", str(tmp_path / "cache"))
    cc.reset_stats()
    yield tmp_path / "cache"
    cc.reset_stats()


def test_off_without_the_env(monkeypatch):
    monkeypatch.delenv("MXTPU_COMPILE_CACHE_DIR", raising=False)
    assert not cc.enabled() and cc.cache_path(KEY) is None
    assert cc.load(KEY) is None and cc.store(KEY, FAKE) is None
    assert cc.stats() == dict.fromkeys(
        ("hits", "misses", "stores", "deserialize_errors", "store_errors"),
        0)


def test_miss_store_hit(cache):
    assert cc.load(KEY) is None
    path = cc.store(KEY, FAKE)
    assert path == cc.cache_path(KEY) and path.startswith(str(cache))
    assert sorted(os.listdir(cache)) == sorted(
        [os.path.basename(path), os.path.basename(path) + ".sha256"])
    lib = cc.load(KEY)
    assert isinstance(lib, ctypes.CDLL)
    assert cc.stats() == {"hits": 1, "misses": 1, "stores": 1,
                          "deserialize_errors": 0, "store_errors": 0}
    assert mx.profiler.metrics()["compile_cache"] == cc.stats()
    # the key holds every part: another toolkit or card is another entry
    assert cc.cache_path(KEY[:3] + ((8, 0),)) != path


@pytest.mark.parametrize("tear", ["truncate", "flip", "no_digest"])
def test_torn_entry_is_counted_and_removed(cache, tear):
    path = cc.store(KEY, FAKE)
    if tear == "truncate":
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    elif tear == "flip":
        with open(path, "r+b") as f:
            f.seek(100)
            b = f.read(1)
            f.seek(100)
            f.write(bytes([b[0] ^ 0xff]))
    else:
        os.remove(path + ".sha256")
    assert cc.load(KEY) is None
    assert cc.stats()["deserialize_errors"] == 1 and cc.stats()["hits"] == 0
    assert not os.path.exists(path)
    assert cc.load(KEY) is None and cc.stats()["misses"] == 1


def test_store_error_keeps_the_build(cache):
    assert cc.store(KEY, str(cache / "no_such_library.so")) is None
    assert cc.stats()["store_errors"] == 1 and cc.stats()["stores"] == 0


def test_build_loads_a_warm_entry_and_rebuilds_a_torn_one(cache, monkeypatch,
                                                          tmp_path):
    """_build with the cache on: a warm entry loads with no nvcc; a torn
    one is counted and built again, and a build that cannot run raises."""
    monkeypatch.setattr(_build, "cache_key", lambda name: (name,) + KEY)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_CACHED", {})
    monkeypatch.setattr(_build, "_BUILD_DIR", str(tmp_path / "build"))

    def no_nvcc():
        raise MXNetError("nvcc not found")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    for name in ("box_nms", "compression"):
        cc.store(_build.cache_key(name), FAKE)
    assert _build.build_all(("box_nms", "compression")) == {
        "box_nms": 0.0, "compression": 0.0}
    assert isinstance(_build.load("box_nms"), ctypes.CDLL)
    assert cc.stats()["hits"] == 2
    torn = cc.cache_path(_build.cache_key("compression"))
    monkeypatch.setattr(_build, "_CACHED", {})
    with open(torn, "r+b") as f:
        f.truncate(64)
    with pytest.raises(MXNetError, match="nvcc not found"):
        _build.build_all(("compression",))
    assert cc.stats()["deserialize_errors"] == 1
    # the in-tree build directory is not consulted while the cache is on
    shutil.copy(FAKE, _build._target("compression")[1])
    with pytest.raises(MXNetError, match="nvcc not found"):
        _build.build_all(("compression",))

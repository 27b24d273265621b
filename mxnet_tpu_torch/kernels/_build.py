"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. Builds happen
at first use, into ``mxnet_tpu_torch/_build/`` (listed in .gitignore), under
a file name keyed by the hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is reused. ``build_all()`` starts one ``nvcc`` per
source, all at once. Each build is recorded in the profiler's compile
registry (``metrics()['compile']``, a span in the ``compile`` lane) as
``kernel:<name>``, with its seconds and its source: the port's counterpart
of the JAX package's XLA compiles.

Nothing here runs at import time: the CPU tests import every module on a
host that has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..base import MXNetError, getenv

__all__ = ["SOURCES", "build_all", "load", "build_log"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "_build")

SOURCES = ("conv_fused", "batchnorm_fused", "optimizer_apply",
           "flash_attention", "quantized_matmul", "compression", "box_nms")

_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_LOCK = threading.Lock()
_LIBS = {}
_LOG = {}


def _nvcc():
    for home in (getenv("CUDA_HOME"), getenv("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise MXNetError("nvcc not found (set CUDA_HOME): the port's CUDA "
                     "kernels are built from source at first use")


def _target(name):
    """(source path, library path): the library's name carries the hash of
    the source, every shared header in csrc/ and the flags."""
    src = os.path.join(_SRC_DIR, name + ".cu")
    digest = hashlib.sha256()
    for path in [src] + sorted(glob.glob(os.path.join(_SRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    digest.update(" ".join(_FLAGS).encode())
    return src, os.path.join(_BUILD_DIR, "lib%s-%s.so"
                             % (name, digest.hexdigest()[:16]))


def build_all(names=SOURCES):
    """Compile every source in ``names`` that is not built yet, one
    ``nvcc`` process each, all started together. Returns
    ``{name: seconds}`` (0.0 where the library was already built)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    procs, times = {}, {}
    t0 = time.perf_counter()
    for name in names:
        src, lib = _target(name)
        if os.path.exists(lib):
            times[name] = 0.0
            continue
        tmp = "%s.%d.tmp" % (lib, os.getpid())
        procs[name] = (subprocess.Popen(
            [_nvcc()] + _FLAGS + ["-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        _LOG[name] = out
        if proc.returncode != 0:
            failed.append("%s (exit %d):\n%s" % (name, proc.returncode, out))
            continue
        os.replace(tmp, lib)
    from .. import profiler as _profiler
    for name, (proc, _tmp, lib) in procs.items():
        if proc.returncode == 0:
            _profiler.record_compile(
                "kernel:%s" % name, key=os.path.basename(lib),
                dur_us=times[name] * 1e6,
                args={"source": "mxnet_tpu_torch/csrc/%s.cu" % name})
    if failed:
        raise MXNetError("nvcc failed for " + "\n".join(failed))
    return times


def build_log(name):
    """nvcc's output (ptxas register and spill report) of the last build
    of ``name`` in this process, or "" if it was already built."""
    return _LOG.get(name, "")


def load(name):
    """The ``ctypes.CDLL`` of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            build_all((name,))
            _LIBS[name] = ctypes.CDLL(_target(name)[1])
    return _LIBS[name]

"""Gluon utility functions (counterpart of mxnet_tpu/gluon/utils.py; ref:
python/mxnet/gluon/utils.py split_data :31, split_and_load :81,
clip_global_norm :115, check_sha1 :159, download :190).

``split_and_load`` slices a batch along its batch axis and places each
slice on one context of ``ctx_list``; with one context it places the
whole batch there (no copy when it is there already).
"""
from __future__ import annotations

import hashlib
import os
import warnings

import numpy as _np

from .. import ndarray as nd
from ..ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download", "shape_is_known"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of an NDArray along ``batch_axis``; with
    ``even_split=False`` the last slice takes the remainder."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data." % (
                str(data.shape), num_slice, batch_axis, num_slice))
    if num_slice == 1:
        return [data]
    step = size // num_slice
    if not even_split:
        return [data.slice_axis(batch_axis, i * step,
                                (i + 1) * step if i < num_slice - 1
                                else size)
                for i in range(num_slice)]
    return [data.slice_axis(batch_axis, i * step, (i + 1) * step)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split ``data`` into ``len(ctx_list)`` slices and place slice i on
    ``ctx_list[i]``; a non-NDArray is first made an NDArray on
    ``ctx_list[0]``."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [i.as_in_context(ctx) for i, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that the 2-norm of all of them together
    is at most ``max_norm``; returns that norm before scaling (a numpy
    scalar with ``check_isfinite``, which also warns when it is inf or
    NaN, else an NDArray, with no host sync)."""
    def _norm(array):
        if array.stype == "default":
            x = array.reshape((-1,))
            return nd.dot(x, x)
        return array.norm().square()

    assert len(arrays) > 0
    ctx = arrays[0].context
    total_norm = nd.add_n(*[_norm(arr).as_in_context(ctx) for arr in arrays])
    total_norm = nd.sqrt(total_norm)
    if check_isfinite:
        if not _np.isfinite(total_norm.asscalar()):
            warnings.warn(
                UserWarning("nan or inf is detected. Clipping results will "
                            "be undefined."), stacklevel=2)
    scale = max_norm / (total_norm + 1e-8)
    scale = nd.minimum(nd.ones(1, ctx=ctx), scale)
    for arr in arrays:
        arr._assign(arr._data * scale._data.to(arr._data.device,
                                               arr._data.dtype))
    if check_isfinite:
        return total_norm.asscalar()
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the file's sha1 digest is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None,
             retries=5, verify_ssl=True):
    """The file of ``url`` at ``path`` (a file or a directory; default the
    URL's file name). As in the JAX package nothing goes over the network:
    a ``file://`` URL is copied, and a file already at the path (with the
    right sha1 when one is given) is returned; anything else raises
    IOError."""
    if path is None:
        fname = url.split("/")[-1]
        assert fname, ("Can't construct file-name from this URL. Please set "
                       "the `path` option manually.")
    else:
        path = os.path.expanduser(path)
        if os.path.isdir(path):
            fname = os.path.join(path, url.split("/")[-1])
        else:
            fname = path
    if url.startswith("file://"):
        src = url[len("file://"):]
        if overwrite or not os.path.exists(fname):
            import shutil
            os.makedirs(os.path.dirname(os.path.abspath(fname)),
                        exist_ok=True)
            shutil.copyfile(src, fname)
        return fname
    if os.path.exists(fname) and not overwrite and (
            sha1_hash is None or check_sha1(fname, sha1_hash)):
        return fname
    raise IOError(
        "download(%r): this package fetches nothing over the network; place "
        "the file at %r beforehand or use a file:// URL" % (url, fname))


def shape_is_known(shape):
    """Whether every dimension of ``shape`` is known (not 0 or -1)."""
    if shape is None:
        return False
    unknown_dim_size = -1
    if len(shape) == 0:
        return unknown_dim_size == -1
    for dim_size in shape:
        if dim_size in (unknown_dim_size, 0):
            return False
    return True

"""Bucketing data iterator and vocabulary helper of the legacy RNN package
(counterpart of mxnet_tpu/rnn/io.py). Batches are NDArrays on the
current context, as ``ndarray.array`` places them."""
from __future__ import annotations

import bisect
import random

import numpy as np

from .. import ndarray
from ..io import DataBatch, DataDesc, DataIter

__all__ = ["encode_sentences", "BucketSentenceIter"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Map token lists to int lists, growing the vocab for unseen tokens."""
    new_vocab = vocab is None
    if new_vocab:
        vocab = {invalid_key: invalid_label}
    idx = start_label
    encoded = []
    for sent in sentences:
        row = []
        for word in sent:
            if word not in vocab:
                assert new_vocab or unknown_token, \
                    "unknown token %s" % word
                if idx == invalid_label:
                    idx += 1
                if unknown_token:
                    word = unknown_token
                vocab[word] = idx
                idx += 1
            row.append(vocab[word])
        encoded.append(row)
    return encoded, vocab


class BucketSentenceIter(DataIter):
    """Language-model iterator that pads each sentence to its bucket and
    yields (data, next-token-label) batches keyed by bucket. The batch
    order comes from Python's ``random`` and the rows' from numpy's global
    state, as in the JAX package."""

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32", layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            counts = np.bincount([len(s) for s in sentences])
            buckets = [i for i, c in enumerate(counts) if c >= batch_size]
        buckets = sorted(buckets)

        per_bucket = [[] for _ in buckets]
        ndiscard = 0
        for sent in sentences:
            buck = bisect.bisect_left(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            row = np.full((buckets[buck],), invalid_label, dtype=dtype)
            row[:len(sent)] = sent
            per_bucket[buck].append(row)
        # drop empty buckets so every batch shape actually occurs
        keep = [i for i, rows in enumerate(per_bucket) if rows]
        self.buckets = [buckets[i] for i in keep]
        self.data = [np.asarray(per_bucket[i], dtype=dtype) for i in keep]
        if ndiscard:
            print("WARNING: discarded %d sentences longer than the largest "
                  "bucket." % ndiscard)

        self.batch_size = batch_size
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.layout = layout
        self.major_axis = layout.find("N")
        if self.major_axis not in (0, 1):
            raise ValueError("invalid layout %r: use NT or TN" % layout)
        self.default_bucket_key = max(self.buckets)

        def _desc(name):
            shape = (batch_size, self.default_bucket_key) \
                if self.major_axis == 0 \
                else (self.default_bucket_key, batch_size)
            return DataDesc(name=name, shape=shape, layout=layout)

        self.provide_data = [_desc(data_name)]
        self.provide_label = [_desc(label_name)]

        self.idx = []
        for i, rows in enumerate(self.data):
            self.idx.extend(
                (i, j)
                for j in range(0, len(rows) - batch_size + 1, batch_size))
        self.curr_idx = 0
        self.nddata = []
        self.ndlabel = []
        self.reset()

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        for rows in self.data:
            np.random.shuffle(rows)
        self.nddata = []
        self.ndlabel = []
        for rows in self.data:
            label = np.empty_like(rows)
            label[:, :-1] = rows[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(ndarray.array(rows, dtype=self.dtype))
            self.ndlabel.append(ndarray.array(label, dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.nddata[i][j:j + self.batch_size]
        label = self.ndlabel[i][j:j + self.batch_size]
        if self.major_axis == 1:
            data = data.T
            label = label.T
        return DataBatch(
            [data], [label], pad=0, bucket_key=self.buckets[i],
            provide_data=[DataDesc(name=self.data_name, shape=data.shape,
                                   layout=self.layout)],
            provide_label=[DataDesc(name=self.label_name,
                                    shape=label.shape,
                                    layout=self.layout)])

"""Train/predict mode and recording state (counterpart of
mxnet_tpu/autograd.py). Recording and backward arrive with training;
here ``is_recording()`` is always False and blocks run under
``torch.no_grad``."""
from __future__ import annotations

import threading

__all__ = ["is_training", "set_training", "is_recording", "pause",
           "train_mode", "predict_mode"]


class _State(threading.local):
    def __init__(self):
        self.training = False
        self.recording = False


_STATE = _State()


def is_recording():
    return _STATE.recording


def is_training():
    return _STATE.training


def set_training(train_mode):
    prev = _STATE.training
    _STATE.training = bool(train_mode)
    return prev


class _RecordingStateScope:
    """Scope guard flipping (recording, training); ``None`` leaves a flag
    as it is."""

    def __init__(self, is_record, train_mode):
        self._enter = (is_record, train_mode)
        self._prev = None

    def __enter__(self):
        self._prev = (_STATE.recording, _STATE.training)
        is_record, train_mode = self._enter
        if is_record is not None:
            _STATE.recording = bool(is_record)
        if train_mode is not None:
            _STATE.training = bool(train_mode)
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training = self._prev
        return False


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)

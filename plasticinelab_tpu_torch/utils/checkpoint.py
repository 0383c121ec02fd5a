"""Training checkpoint / resume (counterpart of
`plasticinelab_tpu/utils/checkpoint.py`): a pickle of nested containers
with every tensor fetched to a host numpy array, written by atomic rename;
`load(path, device_put=True)` turns the arrays back into tensors on a
device. Only files this program wrote should be loaded: unpickling runs
code."""
from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Optional

import numpy as np
import torch


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def save(path: str, payload: Any) -> str:
    """Atomically write a checkpoint (tensors are fetched to the host)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    host = _to_host(payload)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(host, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _to_device(obj, device):
    if isinstance(obj, np.ndarray):
        return torch.as_tensor(obj, device=device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    return obj


def load(path: str, device_put: bool = False, *, device="cuda") -> Any:
    """The saved payload; with `device_put`, its arrays as tensors on
    `device` (the reference puts them on its default device)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return _to_device(payload, torch.device(device)) if device_put else payload


def latest(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    """Most recent checkpoint file `<prefix><step>.pkl` in a directory."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(".pkl"):
            try:
                step = int(name[len(prefix):-4])
            except ValueError:
                continue
            if step > best_step:
                best, best_step = os.path.join(directory, name), step
    return best

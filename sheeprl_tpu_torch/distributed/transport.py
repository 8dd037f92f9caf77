"""The batch digest (counterpart of the digest part of
``sheeprl_tpu/distributed/transport.py``): with ``SHEEPRL_TPU_BATCH_DIGEST`` set, a
decoupled learner appends one sha256 line per consumed batch block to that file, so two
runs can show that they trained on the same data. The transport channel is Sebulba's
and is not ported."""

from __future__ import annotations

import hashlib
import os
from typing import Any

import numpy as np
import torch

#: When set, learner loops append one sha256 line per consumed batch block to this file.
BATCH_DIGEST_ENV_VAR = "SHEEPRL_TPU_BATCH_DIGEST"

# numpy's name of a bfloat16 array's dtype (ml_dtypes' bfloat16 is a 2-byte void type)
_BF16_DTYPE_STR = "<V2"


def _host_leaf(obj: Any):
    """``(dtype string, shape, bytes)`` of a leaf as a numpy copy of it would have them;
    a tensor is read from its device."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _BF16_DTYPE_STR, tuple(t.shape), t.view(torch.int16).numpy().tobytes()
        obj = t.numpy()
    arr = np.ascontiguousarray(np.asarray(obj))
    return arr.dtype.str, arr.shape, arr.tobytes()


def tree_digest(tree: Any) -> str:
    """Order-stable sha256 over every array leaf (dtype, shape and bytes) of a tree of
    dicts, lists and tuples; numpy arrays and tensors hash alike."""
    h = hashlib.sha256()

    def walk(obj: Any, path: str) -> None:
        if isinstance(obj, dict):
            for k in sorted(obj):
                walk(obj[k], f"{path}/{k}")
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(v, f"{path}[{i}]")
        elif obj is None:
            h.update(f"{path}:none".encode())
        else:
            dtype, shape, data = _host_leaf(obj)
            h.update(f"{path}:{dtype}:{shape}".encode())
            h.update(data)

    walk(tree, "")
    return h.hexdigest()


def maybe_digest(tag: str, tree: Any) -> None:
    """Append ``<tag> <sha256>`` for this batch when ``SHEEPRL_TPU_BATCH_DIGEST`` names a
    file; otherwise one environment lookup and nothing else (no copy to the host)."""
    path = os.environ.get(BATCH_DIGEST_ENV_VAR)
    if not path:
        return
    with open(path, "a") as f:
        f.write(f"{tag} {tree_digest(tree)}\n")

"""Checkpoint, resume and the single-update profile (port of
``phdslam_tpu/runtime/checkpoint.py``).

A checkpoint is a directory holding ``checkpoint.pt``: the filter state as
nested plain dicts of CPU tensors, ints and None (no dataclass, so
``torch.load(weights_only=True)`` reads it), and an optional ``extra``
dict of the same kinds (the runners store the step, the carried control
and their generators' states there, ``slam.py::_Runner.save``). Loading
checks the saved tree against a template state of the caller's
configuration and moves it to the template's device.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Optional

import numpy as np
import torch

_FILE = "checkpoint.pt"


def _items(x):
    """(name, child) pairs of a state dataclass or a dict, by name; None
    for a leaf."""
    if dataclasses.is_dataclass(x):
        return sorted((f.name, getattr(x, f.name))
                      for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return sorted(x.items())
    return None


def _leaves(x, prefix=""):
    items = _items(x)
    if items is None:
        return [(prefix, x)]
    out = []
    for k, v in items:
        out += _leaves(v, f"{prefix}.{k}" if prefix else k)
    return out


def _kind(x):
    return ("tensor" if isinstance(x, torch.Tensor)
            else "none" if x is None else type(x).__name__)


def _to_tree(x):
    """A state as nested dicts of CPU tensors, ints and None."""
    if dataclasses.is_dataclass(x):
        return {f.name: _to_tree(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return x


def _from_tree(tree, like):
    """The inverse of :func:`_to_tree`, shaped by the template ``like``."""
    if dataclasses.is_dataclass(like):
        return type(like)(**{f.name: _from_tree(tree[f.name],
                                                getattr(like, f.name))
                             for f in dataclasses.fields(like)})
    return tree


def _device_of(like) -> torch.device:
    for _, leaf in _leaves(like):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def save_checkpoint(path: str, state: Any, extra: Optional[dict] = None):
    """Save a filter state (+ an optional dict of tensors, numbers and
    strings) into the directory ``path``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    payload = {"state": _to_tree(state)}
    if extra:
        payload["extra"] = {k: _to_tree(v) for k, v in extra.items()}
    torch.save(payload, os.path.join(path, _FILE))


def _validate_like(like_tree: Any, loaded_tree: Any, path: str):
    """Structure and shape check of a restored state against the caller's
    ``like`` template: resuming a checkpoint saved under a different
    particle/feature capacity or filter configuration fails here with a
    clear error, not in the first step."""
    like = _leaves(like_tree)
    loaded = _leaves(loaded_tree)
    like_def = [(k, _kind(v)) for k, v in like]
    loaded_def = [(k, _kind(v)) for k, v in loaded]
    if like_def != loaded_def:
        raise ValueError(
            f"checkpoint/config structure mismatch at {path}: saved tree "
            f"{loaded_def} != expected {like_def} (was the checkpoint saved "
            "under a different filter configuration?)")
    for (_, a), (_, b) in zip(like, loaded):
        a_sh, b_sh = tuple(np.shape(a)), tuple(np.shape(b))
        if a_sh != b_sh:
            raise ValueError(
                f"checkpoint/config shape mismatch at {path}: saved leaf "
                f"shape {b_sh} != expected {a_sh} — the checkpoint was "
                "saved under different capacities (n_particles / "
                "max_features / max_measurements); resume with the original "
                "config or re-initialize.")


def load_checkpoint(path: str, like: Any, extra_like: Optional[dict] = None):
    """Load a checkpoint saved by :func:`save_checkpoint` onto the device of
    ``like``, a state of the same structure (e.g. a fresh init_state).

    Returns the state, or ``(state, extra)`` when ``extra_like`` is given
    (extra is None for a checkpoint saved without one).
    """
    path = os.path.abspath(path)
    payload = torch.load(os.path.join(path, _FILE),
                         map_location=_device_of(like), weights_only=True)
    _validate_like(like, payload["state"], path)
    state = _from_tree(payload["state"], like)
    if extra_like is not None:
        return state, payload.get("extra")
    return state


def profile_single_update(cfg, ckpt_path: str, z=None, z_mask=None,
                          device="cuda"):
    """Reload a checkpoint and run exactly one measurement update (no
    prediction, zero control) on the scan ``z`` [M, 2] / ``z_mask`` [M]
    (an empty scan of max_measurements by default): the reference's
    kernel-profiling harness. The first run builds the kernels; the second
    is timed, with CUDA events on the card and the host clock on the CPU.

    Returns {"est_poses": [1, 6], "update_ms", "steps_per_s"}.
    """
    from ..slam import ScanRunner

    if z is None:
        z = np.zeros((cfg.max_measurements, 2), np.float32)
        z_mask = np.zeros((cfg.max_measurements,), bool)
    z = np.asarray(z, np.float32)
    z_mask = np.asarray(z_mask, bool)
    r = ScanRunner(cfg, z[None], z_mask[None], cfg.dt, device=device)
    state = load_checkpoint(ckpt_path, r.state)
    r.state = state
    r.step(0)
    r.state = state
    if r.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(r.device)
        start.record()
        out = r.step(0)
        end.record()
        torch.cuda.synchronize(r.device)
        ms = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        out = r.step(0)
        ms = (time.perf_counter() - t0) * 1000.0
    return {"est_poses": out.expected_pose.cpu().numpy()[None],
            "update_ms": ms, "steps_per_s": 1000.0 / ms}

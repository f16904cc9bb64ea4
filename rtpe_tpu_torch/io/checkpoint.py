"""Checkpointing: train-state snapshots with auto-resume, plus the
reference's per-submodule part snapshots (port of
``rtpe_tpu/io/checkpoint.py``).

The reference saves 7 per-submodule torch statedicts per epoch named
``{timestamp}_epoch{E}_step{S}{part}.statedict`` (``distillation.py:
422-431``) and resumes by uncommenting a load block.  Here:

* :class:`TrainCheckpointer` keeps the whole train state (the step, the
  model's parameters and BN statistics, the optimizer's momentum) with
  retention and latest-step discovery, so a run resumes by itself.  The
  JAX package stores it with orbax; orbax is not on the card's machine,
  so here each step is one ``torch.save`` file of ``{"step",
  "model", "optimizer"}`` state dicts (and a legacy student's dynamic
  loss scaler, ``"scaler"``), written under a temporary name, synced
  and renamed into place.  Like JAX, it does not store the data
  pipeline's RNG.
* :func:`save_student_parts` / :func:`load_student_parts` keep the
  reference's part granularity, one ``.npz`` a part, with the JAX
  package's keys and layouts (``params/att/lo/...``, ``batch_stats/...``;
  HWIO kernels, ``scale``, ``bias``, ``mean``, ``var``), so parts either
  package writes load in the other.
"""

import os
import re
import signal
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from .jax_import import (jax_variables_from_student_state_dict,
                         student_state_dict_from_jax)

# part name -> top-level flax module prefixes (AttentionStudentSteps)
STUDENT_PARTS = {
    "mid_stem": ("mid_stem_conv0", "mid_stem_bn0",
                 "mid_stem_conv1", "mid_stem_bn1"),
    "att_lo": ("att/lo",),
    "att_mid": ("att/mid",),
    "att_hi": ("att/hi",),
    "att_top": ("att_top",),
    "steps": ("step0", "step1", "step2", "det_top"),
    "alt_img_stem": ("alt_stem_conv0", "alt_stem_bn0",
                     "alt_stem_conv1", "alt_stem_bn1"),
}

_COLLECTIONS = ("params", "batch_stats")


def _flatten(tree: Dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _flat_variables(model: nn.Module) -> Dict[str, np.ndarray]:
    """``"params/att/lo/hdc0_conv/kernel" -> array`` of the student."""
    variables = jax_variables_from_student_state_dict(model.state_dict())
    return {"/".join((c,) + path): val
            for c in _COLLECTIONS if c in variables
            for path, val in _flatten(variables[c])}


def _part_of(path) -> Optional[str]:
    joined = "/".join(path)
    for part, prefixes in STUDENT_PARTS.items():
        if any(joined == p or joined.startswith(p + "/")
               for p in prefixes):
            return part
    return None


def _write_parts(buckets: Dict[str, Dict[str, np.ndarray]], out_dir: str,
                 prefix: str) -> List[str]:
    written = []
    for part, arrs in buckets.items():
        if not arrs:
            continue
        path = os.path.join(out_dir, f"{prefix}{part}.statedict.npz")
        np.savez_compressed(path, **arrs)
        written.append(path)
    return written


def save_student_parts(model: nn.Module, out_dir: str,
                       prefix: str) -> List[str]:
    """Write one ``{prefix}{part}.statedict.npz`` per part of
    ``STUDENT_PARTS`` (the stem is the frozen pretrained part and is in
    none)."""
    os.makedirs(out_dir, exist_ok=True)
    buckets: Dict[str, Dict[str, np.ndarray]] = {p: {} for p in
                                                 STUDENT_PARTS}
    for key, val in _flat_variables(model).items():
        part = _part_of(key.split("/")[1:])
        if part is not None:
            buckets[part][key] = val
    return _write_parts(buckets, out_dir, prefix)


def save_parts_by_toplevel(model: nn.Module, out_dir: str,
                           prefix: str) -> List[str]:
    """Part snapshots for any student: one ``.npz`` per top-level module
    (the stem excluded: it is the frozen pretrained part)."""
    os.makedirs(out_dir, exist_ok=True)
    buckets: Dict[str, Dict[str, np.ndarray]] = {}
    for key, val in _flat_variables(model).items():
        top = key.split("/")[1]
        if top != "stem":
            buckets.setdefault(top, {})[key] = val
    return _write_parts(buckets, out_dir, prefix)


@torch.no_grad()
def load_student_parts(model: nn.Module, in_dir: str, prefix: str,
                       parts: Optional[List[str]] = None) -> nn.Module:
    """Load saved parts into ``model`` in place (non-strict over parts:
    a missing file is skipped; strict within a part: every key must be
    the model's, with its shape).  Returns the model."""
    flat = _flat_variables(model)
    for part in (parts or STUDENT_PARTS):
        path = os.path.join(in_dir, f"{prefix}{part}.statedict.npz")
        if not os.path.exists(path):
            continue
        with np.load(path) as npz:
            for key in npz.files:
                tpl = flat.get(key)
                if tpl is None:
                    raise KeyError(f"unknown key {key} in {path}")
                if tuple(np.shape(tpl)) != npz[key].shape:
                    raise ValueError(f"shape mismatch for {key}")
                flat[key] = npz[key]
    tree: Dict = {}
    for key, val in flat.items():
        node = tree
        *mods, leaf = key.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = val
    sd = student_state_dict_from_jax(tree)
    current = model.state_dict()
    for k in sd:
        if k.endswith("num_batches_tracked"):
            sd[k] = current[k]
    model.load_state_dict(sd, strict=True)
    return model


class TrainCheckpointer:
    """Train-state checkpoints in ``directory`` with latest-step resume,
    retention of the newest ``max_to_keep`` and a SIGTERM save hook
    (preemption tolerance).  The state is a
    :class:`~rtpe_tpu_torch.train.step.DistillTrainState` (``step``,
    ``model``, ``optimizer``) or a
    :class:`~rtpe_tpu_torch.train.legacy_steps.StudentTrainState`, whose
    dynamic loss scaler's state is kept too."""

    _NAME = re.compile(r"^step_(\d+)\.pt$")

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def steps(self) -> List[int]:
        """The saved steps, oldest first."""
        found = (self._NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state) -> None:
        path = self._path(step)
        tmp = f"{path}.tmp-{os.getpid()}"
        blob = {"step": int(step), "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict()}
        if getattr(state, "scaler", None) is not None:
            blob["scaler"] = [t.detach().clone() for t in state.scaler]
        with open(tmp, "wb") as f:
            torch.save(blob, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state):
        """Restore the latest checkpoint into ``state`` (its model and
        optimizer in place, on the model's device); returns ``(state,
        step)``, with step None and ``state`` unchanged when there is no
        checkpoint."""
        step = self.latest_step()
        if step is None:
            return state, None
        dev = next(state.model.parameters()).device
        blob = torch.load(self._path(step), map_location=dev,
                          weights_only=True)
        state.model.load_state_dict(blob["model"])
        state.optimizer.load_state_dict(blob["optimizer"])
        if getattr(state, "scaler", None) is not None and "scaler" in blob:
            state.scaler = type(state.scaler)(*blob["scaler"])
        state.step = int(blob["step"])
        return state, step

    def install_sigterm_save(self, get_state) -> None:
        """On SIGTERM, save the current state, then exit with status
        143."""

        def handler(signum, frame):
            state = get_state()
            if state is not None:
                self.save(int(state.step), state)
            raise SystemExit(143)

        signal.signal(signal.SIGTERM, handler)

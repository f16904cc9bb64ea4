"""Load the JAX package's serving artifact directory.

Port of ``rtpe_tpu/io/serving.py:load_serving_artifact`` (and
``_cfg_from_dict``).  The directory, as ``export_serving_artifact``
writes it, holds

* ``weights.npz``: the canonical variable tree, flat
  ``collection/path`` keys (``params/conv1/kernel``, ...);
* ``meta.json``: a format marker, the model config, the predictor's
  construction kwargs, and the weights file's sha256 and array count;
* ``act_scales.json`` for an int8 artifact.

The reader checks the marker, the model family, the sha256 and the
array count as the JAX one does, and rebuilds the nested variable tree
without flax; ``PosePredictor.from_artifact`` serves it through
``state_dict_from_jax``.  An artifact that declares an int8 mode or
flip test-time augmentation raises ``NotImplementedError``: those
serving modes come with later slices of the port.  Writing an artifact
(``export_serving_artifact``) waits too (ROADMAP.md).
"""

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict

import numpy as np

from ..models.hrnet import HRNetConfig, StageCfg

_FORMAT = "rtpe_tpu-serving-artifact-v1"
_META = "meta.json"
_LATER = {"int8": "the int8 serving modes (ROADMAP.md Queue 1 item 5)",
          "int8_act": "the int8 serving modes (ROADMAP.md Queue 1 item 5)",
          "with_flip": "test-time augmentation (ROADMAP.md Queue 1 item 6)"}


def _cfg_from_dict(d: Dict[str, Any]) -> HRNetConfig:
    def tup(v):
        return tuple(v) if isinstance(v, list) else v

    stages = ("stage2", "stage3", "stage4")
    kw = {k: tup(v) for k, v in d.items() if k not in stages}
    for s in stages:
        kw[s] = StageCfg(**{k: tup(v) for k, v in d[s].items()})
    return HRNetConfig(**kw)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """``{"params/a/b/kernel": arr}`` -> ``{"params": {"a": {"b":
    {"kernel": arr}}}}``."""
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return tree


@dataclasses.dataclass
class ServingArtifact:
    """Loaded artifact: everything a serving process constructs from."""
    cfg: HRNetConfig
    variables: Dict[str, Any]
    predictor_kwargs: Dict[str, Any]
    meta: Dict[str, Any]


def load_serving_artifact(path: str) -> ServingArtifact:
    """Read and validate an artifact directory written by the JAX
    package's ``export_serving_artifact``; fails loudly on a foreign or
    truncated meta, a weights file whose sha256 or array count differs
    from the manifest, and on serving modes the port has not yet."""
    mpath = os.path.join(path, _META)
    if not os.path.isfile(mpath):
        raise FileNotFoundError(
            f"{path}: no {_META} — not a serving artifact directory")
    with open(mpath) as f:
        meta = json.load(f)
    if not isinstance(meta, dict) or meta.get("format") != _FORMAT:
        got = (meta.get("format") if isinstance(meta, dict)
               else type(meta).__name__)
        raise ValueError(f"{mpath}: expected format={_FORMAT!r}, got {got!r}")
    if meta.get("model_family") != "pose_higher_hrnet":
        raise ValueError(f"{mpath}: unsupported model_family "
                         f"{meta.get('model_family')!r}")
    pkw = dict(meta["predictor"])
    for name, what in _LATER.items():
        if pkw.get(name):
            raise NotImplementedError(
                f"{mpath} declares {name}=True, which needs {what}: a later "
                "slice of the port brings it")

    wmeta = meta["weights"]
    wpath = os.path.join(path, wmeta["file"])
    got = _sha256(wpath)
    if got != wmeta["sha256"]:
        raise ValueError(f"{wpath}: sha256 mismatch (manifest "
                         f"{wmeta['sha256'][:12]}…, file {got[:12]}…) — "
                         "corrupt or tampered weights")
    with np.load(wpath) as z:
        flat = {k: z[k] for k in z.files}
    if len(flat) != wmeta["num_arrays"]:
        raise ValueError(f"{wpath}: {len(flat)} arrays, manifest says "
                         f"{wmeta['num_arrays']}")
    pkw["scales"] = tuple(float(s) for s in pkw.get("scales", [1.0]))
    return ServingArtifact(cfg=_cfg_from_dict(meta["cfg"]),
                           variables=_unflatten(flat),
                           predictor_kwargs=pkw, meta=meta)

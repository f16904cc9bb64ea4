"""Model factories (port of ``rtpe_tpu/models/factory.py``; reference
``rtpe/helpers.py:32-73``).

``load_pretrained_stem`` waits for the students (ROADMAP.md Queue 1
item 8).
"""

from typing import Callable, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, default_dtype, resolve_device
from ..io.jax_import import strip_fp16_prefix
from .hrnet import PoseHigherHRNet, init_random_, w48_config
from .hrnet_packed import PackedParams, pack_w48_params, packed_forward


def get_hrnet_w48_teacher(w48_statedict_path: Optional[str] = None,
                          seed: int = 0
                          ) -> Tuple[PoseHigherHRNet, Dict[str, torch.Tensor]]:
    """The W48 teacher on the CPU in float32 and its state dict.

    With a path, the reference-format state dict is read with
    ``torch.load(map_location="cpu")`` (a saved module gives its
    ``state_dict()``) and the fp16 ``network_to_half`` ``"1."`` prefix
    is stripped; without one the weights are seeded random
    (:func:`~rtpe_tpu_torch.models.hrnet.init_random_`): no pretrained
    weights ship with the repository.
    """
    model = PoseHigherHRNet(w48_config())
    if w48_statedict_path is None:
        init_random_(model, seed=seed)
    else:
        sd = torch.load(w48_statedict_path, map_location="cpu",
                        weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        sd = {k: v.float() if v.is_floating_point() else v
              for k, v in strip_fp16_prefix(sd).items()}
        model.load_state_dict(sd)
    return model.eval(), model.state_dict()


def get_packed_teacher(w48_statedict_path: Optional[str] = None,
                       dtype: Optional[torch.dtype] = None,
                       device: DeviceLike = None, seed: int = 0
                       ) -> Tuple[Callable, PackedParams]:
    """The W48 teacher on the BN-folded serving forward.

    :returns: ``(forward, packed_params)``: ``forward(packed_params, x,
      pallas_chains=False)`` takes NCHW images and returns the canonical
      model's ``(coarse, refined)``; the weights are folded once here, in
      ``dtype`` (bf16 on CUDA, float32 on the CPU) on ``device``.
    """
    dev = resolve_device(device)
    dtype = default_dtype(dev, dtype)
    cfg = w48_config()
    _, sd = get_hrnet_w48_teacher(w48_statedict_path, seed=seed)
    pk = pack_w48_params(sd, cfg, dtype=dtype, device=dev)

    def forward(packed_params: PackedParams, x: torch.Tensor,
                pallas_chains: bool = False):
        return packed_forward(packed_params, x, cfg, dtype,
                              pallas_chains=pallas_chains)

    return forward, pk

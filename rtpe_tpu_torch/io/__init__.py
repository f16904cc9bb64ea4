"""Weight import: the JAX package's variables -> the port's state dict
(teacher or student), JAX's BN-folded dict -> the port's serving dict,
and the JAX package's serving artifact directory."""

from .jax_import import (  # noqa: F401
    folded_params_from_jax,
    state_dict_from_jax,
    strip_fp16_prefix,
    student_state_dict_from_jax,
)
from .serving import ServingArtifact, load_serving_artifact  # noqa: F401

"""Weight import: the JAX package's variables -> the port's state dict."""

from .jax_import import state_dict_from_jax, strip_fp16_prefix  # noqa: F401

"""Models of the port: the Llama-3 family, forward and KV-cache serving."""

from .llama import (  # noqa: F401
    LlamaConfig,
    forward,
    init_params,
    params_from_jax,
)
# only the factory is re-exported: re-exporting the `generate` function
# would shadow the `models.generate` submodule attribute
from .generate import make_generate_fn  # noqa: F401

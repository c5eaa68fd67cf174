"""Models of the port: the Llama-3 family (forward, training, KV-cache
serving) and the Mixtral-family MoE (training)."""

from .llama import (  # noqa: F401
    LlamaConfig,
    forward,
    init_params,
    params_from_jax,
)
from .moe import MoEConfig  # noqa: F401
# only the factory is re-exported: re-exporting the `generate` function
# would shadow the `models.generate` submodule attribute
from .generate import make_generate_fn  # noqa: F401

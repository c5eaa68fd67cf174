"""Hugging Face checkpoint import: Llama (dense) and Mixtral (MoE).

Counterpart of ``tpu_network_operator/models/convert.py``, with no
third-party package: ``config.json`` is read as JSON (:func:`hf_config`,
which fills missing keys with ``transformers``' class defaults), and the
weights come from the ``*.safetensors`` shards, parsed here
(:class:`SafetensorsDict`), or from ``pytorch_model*.bin`` through
``torch.load``.  The importers map a state dict onto the port's parameter
trees, the reference's layout:

* ``nn.Linear`` stores ``[out, in]`` and the port computes ``x @ W``, so
  every projection is transposed on import;
* layer leaves stack along a leading ``[L, ...]`` axis, expert leaves
  along ``[L, E, ...]``; the router stays f32;
* RoPE: ``transformers`` rotates split halves, as :mod:`..ops.rope` does;
  a checkpoint in Meta's original interleaved layout needs
  :func:`..ops.rope.convert_interleaved_qk` on wq / wk first;
* a tied-embedding checkpoint (Llama-3.2-1B) has no ``lm_head.weight``;
  the head becomes a copy of the embedding's transpose, a tensor of its
  own, since the optimizers and the checkpoint restore write leaves in
  place.

:func:`cfg_to_json` / :func:`cfg_from_json` write and read the
``cfg.json`` sidecar of ``workload convert`` in the reference's schema, so
either package reads the other's; :func:`shard_params` cuts an imported
tree into a rank's shards for ``convert`` over a mesh.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import mmap
import os
from types import SimpleNamespace
from typing import Any, Dict, Iterator, Mapping, Optional

import torch

from .. import resolve_device
from . import llama, moe
from .llama import HybridLlamaConfig, LlamaConfig, Params
from .moe import HybridMoEConfig, MoEConfig

# transformers' class defaults (LlamaConfig / MixtralConfig) for the keys
# the importers read: a config.json lists only the keys that differ from
# them.  num_key_value_heads None means num_attention_heads.
_HF_DEFAULTS = {
    "llama": {
        "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 11008,
        "num_hidden_layers": 32, "num_attention_heads": 32,
        "num_key_value_heads": None, "max_position_embeddings": 2048,
        "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "rope_scaling": None,
        "head_dim": None, "tie_word_embeddings": False,
    },
    "mixtral": {
        "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
        "num_hidden_layers": 32, "num_attention_heads": 32,
        "num_key_value_heads": 8, "max_position_embeddings": 131072,
        "rms_norm_eps": 1e-5, "rope_theta": 1e6, "sliding_window": None,
        "num_local_experts": 8, "num_experts_per_tok": 2,
        "router_aux_loss_coef": 0.001, "head_dim": None,
        "tie_word_embeddings": False,
    },
}


def _unsupported_model_type(model_type) -> ValueError:
    return ValueError(
        f"unsupported HF model_type {model_type!r} — this importer "
        "handles llama (dense) and mixtral (MoE) checkpoints"
    )


def hf_config(d: Mapping[str, Any]) -> SimpleNamespace:
    """The attributes ``transformers.AutoConfig`` would give a
    ``config.json`` of a llama or mixtral checkpoint, for the keys the
    importers read: the file's values over the class defaults."""
    model_type = d.get("model_type")
    if model_type not in _HF_DEFAULTS:
        raise _unsupported_model_type(model_type)
    fields = {**_HF_DEFAULTS[model_type], **d}
    if fields["num_key_value_heads"] is None:
        fields["num_key_value_heads"] = fields["num_attention_heads"]
    if fields["head_dim"] is None:
        fields["head_dim"] = (fields["hidden_size"]
                              // fields["num_attention_heads"])
    scaling = fields.get("rope_scaling")
    if scaling and "type" in scaling and "rope_type" not in scaling:
        fields["rope_scaling"] = {**scaling, "rope_type": scaling["type"]}
    return SimpleNamespace(**fields)


def _check_head_dim(hf: Any) -> None:
    # the port's head_dim is hidden // heads; a checkpoint whose own
    # head_dim differs would load with mis-shaped q / k / v
    head_dim = getattr(hf, "head_dim", None)
    if head_dim is not None and \
            head_dim != hf.hidden_size // hf.num_attention_heads:
        raise ValueError(
            f"head_dim={head_dim} is not hidden_size // num_attention_heads"
            f" = {hf.hidden_size // hf.num_attention_heads}; only that "
            "head width is supported"
        )


def cfg_from_hf(hf: Any, **overrides) -> LlamaConfig:
    """LlamaConfig from a ``transformers`` LlamaConfig or an
    :func:`hf_config` view.  Llama-3.1-style ``rope_scaling``
    (``rope_type: llama3``) is carried over; any other scaling type is
    refused."""
    _check_head_dim(hf)
    fields = dict(
        vocab_size=hf.vocab_size,
        hidden=hf.hidden_size,
        layers=hf.num_hidden_layers,
        heads=hf.num_attention_heads,
        kv_heads=hf.num_key_value_heads,
        ffn=hf.intermediate_size,
        max_seq=hf.max_position_embeddings,
        rope_theta=float(hf.rope_theta),
        rms_eps=float(hf.rms_norm_eps),
    )
    scaling = getattr(hf, "rope_scaling", None)
    if scaling:
        rope_type = scaling.get("rope_type") or scaling.get("type")
        if rope_type == "llama3":
            fields["rope_scaling"] = LlamaConfig.rope_scaling_from(scaling)
        elif rope_type not in (None, "default"):
            raise ValueError(
                f"unsupported rope_scaling type {rope_type!r} — only the "
                "llama3 rule is implemented (ops.rope._llama3_scaled_freqs)"
            )
    fields.update(overrides)
    return LlamaConfig(**fields)


def moe_cfg_from_hf(hf: Any, **overrides) -> MoEConfig:
    """MoEConfig from a ``transformers`` MixtralConfig or an
    :func:`hf_config` view.  The port routes with a static per-expert
    capacity (``capacity_factor``) where Mixtral drops no token; a factor
    of ``num_local_experts / num_experts_per_tok`` or more makes the two
    the same.  ``sliding_window`` is refused: the port attends over the
    whole causal prefix."""
    window = getattr(hf, "sliding_window", None)
    if window is not None:
        raise ValueError(
            f"sliding_window={window} is not supported — full causal "
            "attention only; clear the field to import anyway"
        )
    _check_head_dim(hf)
    fields = dict(
        vocab_size=hf.vocab_size,
        hidden=hf.hidden_size,
        layers=hf.num_hidden_layers,
        heads=hf.num_attention_heads,
        kv_heads=hf.num_key_value_heads,
        ffn=hf.intermediate_size,
        experts=hf.num_local_experts,
        experts_per_token=hf.num_experts_per_tok,
        router_aux_weight=float(getattr(hf, "router_aux_loss_coef", 0.01)),
        max_seq=hf.max_position_embeddings,
        rope_theta=float(hf.rope_theta),
        rms_eps=float(hf.rms_norm_eps),
    )
    fields.update(overrides)
    return MoEConfig(**fields)


# -- weights ------------------------------------------------------------------


def _take(sd: Mapping[str, torch.Tensor], name: str) -> torch.Tensor:
    """One tensor of the (possibly lazy) state dict, by exact name."""
    if name not in sd:
        raise KeyError(f"HF checkpoint lacks {name!r}")
    return sd[name]


def _leaf(src: torch.Tensor, dtype: torch.dtype, dev: torch.device,
          transpose: bool = False, out: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """``src`` as a new tensor (or written into ``out``) on ``dev``, cast
    once to ``dtype`` (one rounding: the reference's widening to f32 first
    is exact) and, for a projection, transposed to [in, out].  The source
    moves in its own dtype, so the cast runs on ``dev``."""
    src = src.to(dev)
    if transpose:
        src = src.t()
    if out is None:
        out = torch.empty(src.shape, dtype=dtype, device=dev)
    elif out.shape != src.shape:
        raise ValueError(f"HF tensor of shape {tuple(src.shape)} where "
                         f"{tuple(out.shape)} is expected")
    return out.copy_(src)


def _stacked(sd, names, dtype, dev, transpose=True) -> torch.Tensor:
    """The tensors ``names`` stacked along a new leading axis, each
    converted by :func:`_leaf` straight into its slot."""
    shape = _take(sd, names[0]).shape
    out = torch.empty((len(names), *(shape[::-1] if transpose else shape)),
                      dtype=dtype, device=dev)
    for i, name in enumerate(names):
        _leaf(_take(sd, name), dtype, dev, transpose, out[i])
    return out


def _head(sd, embed: torch.Tensor, dtype, dev) -> torch.Tensor:
    if "lm_head.weight" in sd:
        return _leaf(sd["lm_head.weight"], dtype, dev, transpose=True)
    # tied embeddings: the head is the embedding matrix, as a tensor of
    # its own (leaves are updated and restored in place)
    return embed.t().contiguous()


def from_hf_llama(state_dict: Mapping[str, torch.Tensor], cfg: LlamaConfig,
                  device=None) -> Params:
    """The port's Llama tree on ``device`` (None means CUDA) from an HF
    Llama state dict (``model.state_dict()``, a :class:`SafetensorsDict`,
    or a bare ``LlamaModel``'s keys without ``model.``).  Only membership
    tests and lookups by name touch ``state_dict``, so a lazy mapping
    streams one tensor at a time."""
    sd, dev, dt = state_dict, resolve_device(device), cfg.dtype
    prefix = "model."
    if f"{prefix}embed_tokens.weight" not in sd and "embed_tokens.weight" in sd:
        prefix = ""

    def stacked(fmt: str, transpose: bool = True) -> torch.Tensor:
        names = [prefix + fmt.format(i=i) for i in range(cfg.layers)]
        return _stacked(sd, names, dt, dev, transpose)

    embed = _leaf(_take(sd, f"{prefix}embed_tokens.weight"), dt, dev)
    attn, mlp = "layers.{i}.self_attn.", "layers.{i}.mlp."
    return {
        "embed": embed,
        "layers": {
            "wq": stacked(attn + "q_proj.weight"),
            "wk": stacked(attn + "k_proj.weight"),
            "wv": stacked(attn + "v_proj.weight"),
            "wo": stacked(attn + "o_proj.weight"),
            "w_gate": stacked(mlp + "gate_proj.weight"),
            "w_up": stacked(mlp + "up_proj.weight"),
            "w_down": stacked(mlp + "down_proj.weight"),
            "ln_attn": stacked("layers.{i}.input_layernorm.weight", False),
            "ln_mlp": stacked("layers.{i}.post_attention_layernorm.weight",
                              False),
        },
        "ln_final": _leaf(_take(sd, f"{prefix}norm.weight"), dt, dev),
        "lm_head": _head(sd, embed, dt, dev),
    }


def from_hf_mixtral(state_dict: Mapping[str, torch.Tensor], cfg: MoEConfig,
                    device=None) -> Params:
    """The port's MoE tree on ``device`` (None means CUDA) from an HF
    Mixtral state dict: HF's experts ``w1`` / ``w3`` / ``w2`` are the
    SwiGLU gate / up / down projections, stacked [L, E, in, out]; the
    router [L, hidden, E] stays f32."""
    sd, dev, dt = state_dict, resolve_device(device), cfg.dtype
    layer = "model.layers.{i}."

    def stacked(fmt: str, dtype=dt, transpose: bool = True) -> torch.Tensor:
        names = [layer.format(i=i) + fmt for i in range(cfg.layers)]
        return _stacked(sd, names, dtype, dev, transpose)

    def experts(w: str) -> torch.Tensor:
        names = [f"{layer.format(i=i)}block_sparse_moe.experts.{e}.{w}.weight"
                 for i in range(cfg.layers) for e in range(cfg.experts)]
        out = _stacked(sd, names, dt, dev)
        return out.view(cfg.layers, cfg.experts, *out.shape[1:])

    embed = _leaf(_take(sd, "model.embed_tokens.weight"), dt, dev)
    return {
        "embed": embed,
        "layers": {
            "wq": stacked("self_attn.q_proj.weight"),
            "wk": stacked("self_attn.k_proj.weight"),
            "wv": stacked("self_attn.v_proj.weight"),
            "wo": stacked("self_attn.o_proj.weight"),
            "router": stacked("block_sparse_moe.gate.weight", torch.float32),
            "w_gate": experts("w1"),
            "w_up": experts("w3"),
            "w_down": experts("w2"),
            "ln_attn": stacked("input_layernorm.weight", transpose=False),
            "ln_mlp": stacked("post_attention_layernorm.weight",
                              transpose=False),
        },
        "ln_final": _leaf(_take(sd, "model.norm.weight"), dt, dev),
        "lm_head": _head(sd, embed, dt, dev),
    }


# -- the checkpoint reader ----------------------------------------------------

# safetensors dtype names the reader takes
_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
              "F32": torch.float32}


class SafetensorsDict(Mapping):
    """A lazy state dict over ``*.safetensors`` shards: each file's
    header is parsed once (an 8-byte little-endian length, then a JSON
    object of ``name -> {dtype, shape, data_offsets}``, ``__metadata__``
    aside), and a tensor is read when asked for, from a copy-on-write
    memory map of its file, with no copy of the checkpoint in memory.
    BF16, F16 and F32 tensors are read; other dtypes are refused by
    name."""

    def __init__(self, files):
        self._where: Dict[str, tuple] = {}
        for path in files:
            with open(path, "rb") as f:
                n = int.from_bytes(f.read(8), "little")
                header = json.loads(f.read(n))
                buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
            for name, info in header.items():
                if name != "__metadata__":
                    self._where[name] = (buf, 8 + n, info, path)

    def __getitem__(self, name: str) -> torch.Tensor:
        buf, base, info, path = self._where[name]
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(
                f"{path}: tensor {name!r} has dtype {info['dtype']}; the "
                f"reader takes {sorted(_ST_DTYPES)}"
            )
        begin, end = info["data_offsets"]
        shape = info["shape"]
        count = (end - begin) // dtype.itemsize
        if count != torch.Size(shape).numel():
            raise ValueError(f"{path}: tensor {name!r} has {end - begin} "
                             f"bytes for shape {shape}")
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(buf, dtype=dtype, count=count,
                                offset=base + begin).view(shape)

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)


def load_state_dict(path: str) -> Mapping[str, torch.Tensor]:
    """The state dict of the HF checkpoint directory ``path``: its
    ``*.safetensors`` shards as a :class:`SafetensorsDict`, else its
    ``pytorch_model*.bin`` files, memory-mapped, tensors only."""
    shards = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if shards:
        return SafetensorsDict(shards)
    bins = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if not bins:
        raise FileNotFoundError(
            f"{path} holds neither *.safetensors nor pytorch_model*.bin")
    sd: Dict[str, torch.Tensor] = {}
    for b in bins:
        sd.update(torch.load(b, map_location="cpu", weights_only=True,
                             mmap=True))
    return sd


def load_hf_checkpoint(path: str, dtype: torch.dtype = torch.bfloat16,
                       device=None):
    """(params, cfg) from a local HF checkpoint directory, Llama or
    Mixtral by the config's ``model_type``, the tensors on ``device``
    (None means CUDA)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        hf = hf_config(json.load(f))
    if hf.model_type == "llama":
        cfg = cfg_from_hf(hf, dtype=dtype)
        return from_hf_llama(load_state_dict(path), cfg, dev), cfg
    cfg = moe_cfg_from_hf(hf, dtype=dtype)
    return from_hf_mixtral(load_state_dict(path), cfg, dev), cfg


# -- the cfg.json sidecar -----------------------------------------------------


def model(cfg):
    """The module of ``cfg``'s model family, picked by the config's type:
    :mod:`.moe` for a MoE config, :mod:`.llama` otherwise.  The one place
    that tells the families apart; the rest reads the module (its
    ``Layout``, ``param_specs``, ``init_params``)."""
    return moe if isinstance(cfg, MoEConfig) else llama


def family(cfg) -> str:
    """The ``cfg.json`` tag of ``cfg``'s family: "moe" or "llama"."""
    return "moe" if model(cfg) is moe else "llama"


def param_specs(cfg) -> Params:
    """The family's training layout (its ``param_specs``)."""
    return model(cfg).param_specs(cfg)


def shard_params(params: Params, cfg, mesh) -> Params:
    """This rank's shards of an imported (whole) tree in the family's
    training layout: the reference's ``assign_shardings``, each leaf cut
    by its :func:`param_specs` entry and this rank's part kept."""
    return llama.shard_tree(params, param_specs(cfg), mesh)


def cfg_to_json(cfg) -> str:
    """The sidecar of an imported checkpoint (``workload convert``): the
    config's fields, a ``family`` tag, the dtype by name and the rope
    scaling as a mapping, in the reference's schema."""
    d = dataclasses.asdict(cfg)
    d["family"] = family(cfg)
    d["dtype"] = str(cfg.dtype).removeprefix("torch.")
    if isinstance(cfg, LlamaConfig) and cfg.rope_scaling:
        d["rope_scaling"] = dict(cfg.rope_scaling)
    return json.dumps(d, indent=2, sort_keys=True)


def cfg_from_json(text: str):
    """A LlamaConfig or MoEConfig from :func:`cfg_to_json`'s text, or the
    reference's."""
    d = json.loads(text)
    fam = d.pop("family", "llama")
    dtype = getattr(torch, d["dtype"], None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"cfg.json: unknown dtype {d['dtype']!r}")
    d["dtype"] = dtype
    hybrid = "layer_types" in d
    if fam == "moe":
        return (HybridMoEConfig if hybrid else MoEConfig)(**d)
    d["rope_scaling"] = LlamaConfig.rope_scaling_from(d.get("rope_scaling"))
    return (HybridLlamaConfig if hybrid else LlamaConfig)(**d)


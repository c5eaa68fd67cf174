"""The port's HF checkpoint import held against the JAX package's
``models/convert.py`` and against ``transformers``, on the CPU.

Random-init ``transformers`` models (seeded) are the checkpoints: their
state dicts, and the directories ``save_pretrained`` writes (safetensors
in f32 and bf16, sharded, and ``pytorch_model.bin``).  The port reads
those with its own reader; the JAX package reads them through
``transformers`` and ``safetensors``.  Each tolerance is stated beside its
reason.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from tpu_network_operator.models import convert as jconvert
from tpu_network_operator.models import llama as jllama
from tpu_network_operator.models import moe as jmoe
from tpu_network_operator.ops import rope as jrope
from tpu_network_operator_torch.models import convert as tconvert
from tpu_network_operator_torch.models import generate as tgen
from tpu_network_operator_torch.models import llama as tllama
from tpu_network_operator_torch.models import moe as tmoe
from tpu_network_operator_torch.models import training as ttraining
from tpu_network_operator_torch.ops import rope as trope

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
LLAMA3_SCALING = {
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 16,
}


def llama_hf_cfg(**kw):
    """tests/test_convert.py's tiny Llama (head_dim 16: plain attention)."""
    return transformers.LlamaConfig(**{
        "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "max_position_embeddings": 128,
        "rope_theta": 500_000.0, "rms_norm_eps": 1e-5,
        "tie_word_embeddings": False, **kw})


def mixtral_hf_cfg(**kw):
    """tests/test_convert.py's tiny Mixtral."""
    return transformers.MixtralConfig(**{
        "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "num_local_experts": 4,
        "num_experts_per_tok": 2, "max_position_embeddings": 128,
        "rope_theta": 1e6, "rms_norm_eps": 1e-5,
        "tie_word_embeddings": False, **kw})


def hf_model(cfg, seed):
    torch.manual_seed(seed)
    cls = (transformers.MixtralForCausalLM
           if cfg.model_type == "mixtral" else transformers.LlamaForCausalLM)
    return cls(cfg).eval()


@pytest.fixture(scope="module")
def llama_model():
    return hf_model(llama_hf_cfg(), 7)


@pytest.fixture(scope="module")
def scaled_llama_model():
    # a low theta and a small original context put much of the spectrum
    # in the scaled band over 48 positions (tests/test_convert.py)
    return hf_model(llama_hf_cfg(rope_theta=10_000.0,
                                 rope_scaling=dict(LLAMA3_SCALING)), 11)


@pytest.fixture(scope="module")
def mixtral_model():
    return hf_model(mixtral_hf_cfg(), 5)


def _bits(a) -> np.ndarray:
    """Raw bits of a torch tensor or a JAX / numpy array, for equality
    that sees every bit (bf16 included)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy().view(np.uint8)
    a = np.asarray(a)
    return a.view(np.uint8)


def assert_same_tree(port, ref, path=""):
    """Every leaf of the port's tree has the reference leaf's shape, dtype
    and bits; the two trees have the same keys."""
    assert set(port) == set(ref), path
    for k, v in port.items():
        if isinstance(v, dict):
            assert_same_tree(v, ref[k], f"{path}/{k}")
            continue
        r = np.asarray(ref[k])
        assert tuple(v.shape) == r.shape, f"{path}/{k}"
        assert str(v.dtype).removeprefix("torch.") == r.dtype.name, \
            f"{path}/{k}"
        assert np.array_equal(_bits(v), _bits(r)), f"{path}/{k}"


def same_fields(port_cfg, jax_cfg):
    """The port's config and the reference's agree field by field."""
    pd, jd = dataclasses.asdict(port_cfg), dataclasses.asdict(jax_cfg)
    assert JDT[pd.pop("dtype")] == jd.pop("dtype")
    assert pd == jd


# -- config -------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "llama3_scaling", "type_key",
                                  "default_scaling"])
def test_cfg_from_hf_matches_jax(case):
    kw = {"plain": {},
          "llama3_scaling": {"rope_scaling": dict(LLAMA3_SCALING)},
          # the pre-4.43 spelling: "type" in place of "rope_type"
          "type_key": {"rope_scaling": {
              **{k: v for k, v in LLAMA3_SCALING.items() if k != "rope_type"},
              "type": "llama3"}},
          "default_scaling": {"rope_scaling": {"rope_type": "default"}},
          }[case]
    hf = llama_hf_cfg(**kw)
    port = tconvert.cfg_from_hf(hf, dtype=torch.float32)
    same_fields(port, jconvert.cfg_from_hf(hf, dtype=jnp.float32))
    assert (port.rope_scaling is not None) == (case in ("llama3_scaling",
                                                        "type_key"))


@pytest.mark.parametrize("case", ["plain", "aux_coef", "capacity_override"])
def test_moe_cfg_from_hf_matches_jax(case):
    hf = mixtral_hf_cfg(**({"router_aux_loss_coef": 0.001}
                           if case == "aux_coef" else {}))
    over = {"capacity_factor": 2.0} if case == "capacity_override" else {}
    port = tconvert.moe_cfg_from_hf(hf, dtype=torch.float32, **over)
    same_fields(port, jconvert.moe_cfg_from_hf(hf, dtype=jnp.float32,
                                               **over))
    if case == "aux_coef":
        assert port.router_aux_weight == 0.001


def test_unsupported_configs_are_refused_as_the_reference_refuses():
    yarn = llama_hf_cfg()
    yarn.rope_scaling = {"rope_type": "yarn", "factor": 4.0}
    window = mixtral_hf_cfg(sliding_window=4096)
    for port_fn, jax_fn, hf, match in (
            (tconvert.cfg_from_hf, jconvert.cfg_from_hf, yarn,
             "rope_scaling"),
            (tconvert.moe_cfg_from_hf, jconvert.moe_cfg_from_hf, window,
             "sliding_window")):
        with pytest.raises(ValueError, match=match):
            jax_fn(hf)
        with pytest.raises(ValueError, match=match):
            port_fn(hf)
    with pytest.raises(ValueError, match="unsupported HF model_type 'gpt2'"):
        tconvert.hf_config({"model_type": "gpt2"})
    # a head width other than hidden // heads: the reference would import
    # mis-shaped q / k / v; the port refuses it
    with pytest.raises(ValueError, match="head_dim=32"):
        tconvert.cfg_from_hf(llama_hf_cfg(head_dim=32))


@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_config_json_view_fills_transformers_defaults(tmp_path, family):
    # a config.json listing only what the architecture needs: the view's
    # defaults are transformers' class defaults, not the reference's
    # getattr fallbacks
    hf = llama_hf_cfg() if family == "llama" else mixtral_hf_cfg()
    hf.save_pretrained(tmp_path)
    d = json.loads((tmp_path / "config.json").read_text())
    optional = ["rms_norm_eps", "rope_theta", "max_position_embeddings",
                "num_key_value_heads", "rope_scaling", "head_dim",
                "sliding_window", "router_aux_loss_coef",
                "tie_word_embeddings"]
    for key in optional:
        d.pop(key, None)
    (tmp_path / "config.json").write_text(json.dumps(d))
    auto = transformers.AutoConfig.from_pretrained(tmp_path)
    view = tconvert.hf_config(d)
    if family == "llama":
        port = tconvert.cfg_from_hf(view, dtype=torch.float32)
        ref = jconvert.cfg_from_hf(auto, dtype=jnp.float32)
        assert (port.rms_eps, port.rope_theta, port.max_seq,
                port.kv_heads) == (1e-6, 10000.0, 2048, port.heads)
    else:
        port = tconvert.moe_cfg_from_hf(view, dtype=torch.float32)
        ref = jconvert.moe_cfg_from_hf(auto, dtype=jnp.float32)
        assert (port.router_aux_weight, port.rope_theta,
                port.max_seq) == (0.001, 1e6, 131072)
    same_fields(port, ref)


# -- weights ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_imported_leaves_equal_jax(llama_model, mixtral_model, family,
                                   dtype):
    # f32: the same values; bf16: one rounding of the f32 source on both
    # sides, so the same bits
    model = llama_model if family == "llama" else mixtral_model
    sd = model.state_dict()
    if family == "llama":
        cfg = tconvert.cfg_from_hf(model.config, dtype=dtype)
        port = tconvert.from_hf_llama(sd, cfg, "cpu")
        ref = jconvert.from_hf_llama(
            sd, jconvert.cfg_from_hf(model.config, dtype=JDT[dtype]))
    else:
        cfg = tconvert.moe_cfg_from_hf(model.config, dtype=dtype)
        port = tconvert.from_hf_mixtral(sd, cfg, "cpu")
        ref = jconvert.from_hf_mixtral(
            sd, jconvert.moe_cfg_from_hf(model.config, dtype=JDT[dtype]))
        assert port["layers"]["router"].dtype == torch.float32
    assert_same_tree(port, jax.tree.map(np.asarray, ref))
    # the import copies: training it in place leaves the HF model alone
    for leaf in ttraining.tree_leaves(port):
        assert all(leaf.untyped_storage().data_ptr()
                   != t.untyped_storage().data_ptr() for t in sd.values())


def test_bare_llama_model_state_dict_imports(llama_model):
    # a LlamaModel's keys lack the "model." prefix and it has no head
    sd = {k.removeprefix("model."): v
          for k, v in llama_model.state_dict().items()}
    del sd["lm_head.weight"]
    cfg = tconvert.cfg_from_hf(llama_model.config, dtype=torch.float32)
    port = tconvert.from_hf_llama(sd, cfg, "cpu")
    ref = jconvert.from_hf_llama(
        sd, jconvert.cfg_from_hf(llama_model.config, dtype=jnp.float32))
    assert_same_tree(port, jax.tree.map(np.asarray, ref))


@pytest.mark.parametrize("case", ["plain", "llama3_scaling"])
def test_llama_logits_match_transformers_and_jax(llama_model,
                                                 scaled_llama_model, case):
    # f32 through 2 layers, summed in other orders by the three stacks:
    # 2e-4 against transformers (the reference suite's bound), 1e-5
    # against the JAX model (the same algorithm)
    model = llama_model if case == "plain" else scaled_llama_model
    cfg = tconvert.cfg_from_hf(model.config, dtype=torch.float32)
    assert (cfg.rope_scaling is not None) == (case == "llama3_scaling")
    params = tconvert.from_hf_llama(model.state_dict(), cfg, "cpu")
    toks = np.arange(48)[None, :] * 37 % 256
    with torch.no_grad():
        ref = model(torch.tensor(toks)).logits.numpy()
        out = tllama.forward(params, torch.tensor(toks), cfg).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
    jcfg = jconvert.cfg_from_hf(model.config, dtype=jnp.float32)
    jparams = jconvert.from_hf_llama(model.state_dict(), jcfg)
    jout = np.asarray(jllama.forward(jparams, jnp.asarray(toks), jcfg))
    np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-5)


def test_mixtral_logits_match_transformers_and_jax(mixtral_model):
    # capacity factor E/k: the capacity router drops no token, as
    # Mixtral's; f32 through 2 layers: 5e-4 against transformers (the
    # reference suite's bound), 1e-5 against the JAX model
    hf = mixtral_model.config
    cap = float(hf.num_local_experts // hf.num_experts_per_tok)
    cfg = tconvert.moe_cfg_from_hf(hf, dtype=torch.float32,
                                   capacity_factor=cap)
    params = tconvert.from_hf_mixtral(mixtral_model.state_dict(), cfg, "cpu")
    toks = np.array([[7, 250, 3, 99, 41, 5, 180, 66]])
    with torch.no_grad():
        ref = mixtral_model(torch.tensor(toks)).logits.numpy()
        out, _ = tmoe.forward(params, torch.tensor(toks), cfg)
    np.testing.assert_allclose(out.numpy(), ref, rtol=5e-4, atol=5e-4)
    jcfg = jconvert.moe_cfg_from_hf(hf, dtype=jnp.float32,
                                    capacity_factor=cap)
    jparams = jconvert.from_hf_mixtral(mixtral_model.state_dict(), jcfg)
    jout, _ = jmoe.forward(jparams, jnp.asarray(toks), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)


def test_greedy_decode_matches_transformers(llama_model):
    cfg = tconvert.cfg_from_hf(llama_model.config, dtype=torch.float32)
    params = tconvert.from_hf_llama(llama_model.state_dict(), cfg, "cpu")
    prompt = torch.tensor([[5, 9, 33, 2]])
    with torch.no_grad():
        ref = llama_model.generate(prompt, max_new_tokens=8, do_sample=False,
                                   num_beams=1, pad_token_id=0)
    out = tgen.generate(params, prompt, cfg, max_new_tokens=8)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_tied_lm_head_is_a_tensor_of_its_own(llama_model, mixtral_model,
                                             family):
    model = llama_model if family == "llama" else mixtral_model
    sd = {k: v for k, v in model.state_dict().items()
          if k != "lm_head.weight"}
    if family == "llama":
        params = tconvert.from_hf_llama(
            sd, tconvert.cfg_from_hf(model.config, dtype=torch.float32),
            "cpu")
    else:
        params = tconvert.from_hf_mixtral(
            sd, tconvert.moe_cfg_from_hf(model.config, dtype=torch.float32),
            "cpu")
    embed, head = params["embed"], params["lm_head"]
    assert torch.equal(head, embed.t())
    assert head.is_contiguous()
    assert head.untyped_storage().data_ptr() \
        != embed.untyped_storage().data_ptr()
    embed.add_(1.0)        # an in-place update of one leaf ...
    assert torch.equal(head + 1.0, embed.t())     # ... leaves the other


@pytest.mark.parametrize("family,name", [
    ("llama", "model.layers.1.mlp.up_proj.weight"),
    ("llama", "model.norm.weight"),
    ("mixtral", "model.layers.0.block_sparse_moe.experts.1.w2.weight"),
    ("mixtral", "model.layers.1.block_sparse_moe.gate.weight"),
])
def test_missing_tensor_raises_keyerror_naming_it(llama_model, mixtral_model,
                                                  family, name):
    model = llama_model if family == "llama" else mixtral_model
    sd = dict(model.state_dict())
    del sd[name]
    with pytest.raises(KeyError, match=name.replace(".", r"\.")):
        if family == "llama":
            tconvert.from_hf_llama(
                sd, tconvert.cfg_from_hf(model.config), "cpu")
        else:
            tconvert.from_hf_mixtral(
                sd, tconvert.moe_cfg_from_hf(model.config), "cpu")


# -- the checkpoint reader ----------------------------------------------------


SAVES = {
    "safetensors_f32": dict(safe_serialization=True),
    "safetensors_bf16_sharded": dict(safe_serialization=True,
                                     max_shard_size="60KB"),
    "pytorch_bin": dict(safe_serialization=False),
}


@pytest.mark.parametrize("save", list(SAVES))
@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_reader_equals_jax_load_hf_checkpoint(llama_model, mixtral_model,
                                              tmp_path, family, save):
    model = llama_model if family == "llama" else mixtral_model
    if "bf16" in save:
        model = hf_model(model.config, 3).to(torch.bfloat16)
    model.save_pretrained(tmp_path, **SAVES[save])
    files = sorted(p.name for p in tmp_path.iterdir())
    if "sharded" in save:
        assert sum(f.endswith(".safetensors") for f in files) > 1, files
    if save == "pytorch_bin":
        assert "pytorch_model.bin" in files, files
    for dtype in (torch.float32, torch.bfloat16):
        params, cfg = tconvert.load_hf_checkpoint(str(tmp_path), dtype,
                                                  "cpu")
        ref, jcfg = jconvert.load_hf_checkpoint(str(tmp_path), JDT[dtype])
        same_fields(cfg, jcfg)
        assert_same_tree(params, jax.tree.map(np.asarray, ref))


def test_reader_needs_neither_safetensors_nor_transformers(llama_model,
                                                           tmp_path,
                                                           monkeypatch):
    llama_model.save_pretrained(tmp_path / "st", safe_serialization=True)
    llama_model.save_pretrained(tmp_path / "bin", safe_serialization=False)
    want = tconvert.from_hf_llama(
        llama_model.state_dict(),
        tconvert.cfg_from_hf(llama_model.config), "cpu")
    # an import of either package now raises ImportError
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "transformers", None)
    for sub in ("st", "bin"):
        params, cfg = tconvert.load_hf_checkpoint(str(tmp_path / sub),
                                                  device="cpu")
        assert cfg == tconvert.cfg_from_hf(llama_model.config)
        for a, b in zip(ttraining.tree_leaves(params),
                        ttraining.tree_leaves(want)):
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def _write_safetensors(path, tensors):
    """A safetensors file written by hand: {name: (dtype name, bytes,
    shape)}."""
    header, blobs, off = {"__metadata__": {"format": "pt"}}, [], 0
    for name, (dt, raw, shape) in tensors.items():
        header[name] = {"dtype": dt, "shape": shape,
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    path.write_bytes(len(h).to_bytes(8, "little") + h + b"".join(blobs))


def test_safetensors_reader_parses_the_format_and_refuses_other_dtypes(
        tmp_path):
    f16 = np.arange(6, dtype=np.float16).reshape(2, 3)
    bf16 = torch.tensor([1.5, -2.25, 3.0e38], dtype=torch.bfloat16)
    _write_safetensors(tmp_path / "a.safetensors", {
        "h": ("F16", f16.tobytes(), [2, 3]),
        "b": ("BF16", bf16.view(torch.int16).numpy().tobytes(), [3]),
        "i": ("I64", np.arange(2, dtype=np.int64).tobytes(), [2]),
        "e": ("F32", b"", [0, 4]),
    })
    sd = tconvert.SafetensorsDict([tmp_path / "a.safetensors"])
    assert sorted(sd) == ["b", "e", "h", "i"] and len(sd) == 4
    assert torch.equal(sd["h"], torch.from_numpy(f16))
    assert torch.equal(sd["b"].view(torch.int16), bf16.view(torch.int16))
    assert sd["e"].shape == (0, 4) and sd["e"].dtype == torch.float32
    with pytest.raises(ValueError, match="'i' has dtype I64"):
        sd["i"]


# -- the cfg.json sidecar -----------------------------------------------------


def _presets():
    cases = [(name, getattr(jllama.LlamaConfig, name)())
             for name in ("tiny", "llama3_150m", "llama3_1b", "llama3_3b",
                          "llama3_8b")]
    cases += [("moe_" + name, getattr(jmoe.MoEConfig, name)())
              for name in ("tiny", "small", "mixtral_8x7b")]
    cases.append(("rope_scaled_import", jconvert.cfg_from_hf(
        llama_hf_cfg(rope_scaling=dict(LLAMA3_SCALING)))))
    cases.append(("f32_ffn_xent", dataclasses.replace(
        jllama.LlamaConfig.tiny(), dtype=jnp.float32, remat_policy="ffn",
        xent_chunk=64)))
    return cases


@pytest.mark.parametrize("name,jcfg", _presets(), ids=lambda v: v
                         if isinstance(v, str) else "")
def test_sidecar_reads_both_ways(name, jcfg):
    port = tconvert.cfg_from_json(jconvert.cfg_to_json(jcfg))
    same_fields(port, jcfg)
    back = jconvert.cfg_from_json(tconvert.cfg_to_json(port))
    assert back == jcfg
    assert tconvert.cfg_to_json(port) == jconvert.cfg_to_json(jcfg)


def test_sidecar_refuses_seq_parallel():
    # refused while the port had no mesh; the sidecar now carries
    # seq_parallel=true both ways, as the reference's does
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), seq_parallel=True)
    text = jconvert.cfg_to_json(jcfg)
    port = tconvert.cfg_from_json(text)
    assert port.seq_parallel is True
    same_fields(port, jcfg)
    assert tconvert.cfg_to_json(port) == text
    assert jconvert.cfg_from_json(tconvert.cfg_to_json(port)) == jcfg


# -- interleaved RoPE (tests/test_rope.py's invariants, and the JAX
# helpers' values) -----------------------------------------------------------


def test_interleaved_rope_helpers_match_jax():
    rng = np.random.default_rng(0)
    b, s, h, d = 2, 16, 4, 64
    q, k = (rng.standard_normal((b, s, h, d), dtype=np.float32)
            for _ in range(2))
    cos, sin = jrope.rope_angles(s, d)
    c, sn = np.array(cos)[:, None, :], np.array(sin)[:, None, :]
    perm = trope.deinterleave_perm(d)
    np.testing.assert_array_equal(perm.numpy(),
                                  np.asarray(jrope.deinterleave_perm(d)))
    qi = trope.rotate_interleaved(torch.from_numpy(q), torch.from_numpy(c),
                                  torch.from_numpy(sn))
    np.testing.assert_allclose(
        qi.numpy(), np.asarray(jrope.rotate_interleaved(q, c, sn)),
        rtol=1e-6, atol=1e-6)
    # scores under interleaved pairs == scores of permuted channels under
    # split halves: the checkpoint-conversion invariant
    ki = trope.rotate_interleaved(torch.from_numpy(k), torch.from_numpy(c),
                                  torch.from_numpy(sn))
    tc, ts = trope.rope_angles(s, d, theta=500_000.0)
    qh = trope.apply_rope(torch.from_numpy(q)[..., perm], tc, ts)
    kh = trope.apply_rope(torch.from_numpy(k)[..., perm], tc, ts)
    torch.testing.assert_close(torch.einsum("bqhd,bkhd->bhqk", qh, kh),
                               torch.einsum("bqhd,bkhd->bhqk", qi, ki),
                               rtol=1e-5, atol=1e-5)
    w = rng.standard_normal((8, 2 * 16), dtype=np.float32)
    np.testing.assert_array_equal(
        trope.convert_interleaved_qk(torch.from_numpy(w), 16).numpy(),
        np.asarray(jrope.convert_interleaved_qk(jnp.asarray(w), 16)))


# -- workload convert -> train ------------------------------------------------


def _cli(capsys, argv):
    from tpu_network_operator_torch.workload import cli

    assert cli.main([*argv, "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_workload_convert_then_train_resumes_with_the_sidecar(
        capsys, tmp_path, family):
    # a geometry that is no preset's: resuming under --preset tiny would
    # fail structurally, so success proves the sidecar won
    if family == "llama":
        hf = llama_hf_cfg(vocab_size=384, intermediate_size=192,
                          rope_theta=10_000.0,
                          rope_scaling=dict(LLAMA3_SCALING))
    else:
        hf = mixtral_hf_cfg(vocab_size=320, intermediate_size=96)
    hf_model(hf, 3).save_pretrained(tmp_path / "hf", safe_serialization=True)
    ckpt = tmp_path / "ckpt"
    r = _cli(capsys, ["convert", "--hf-path", str(tmp_path / "hf"),
                      "--checkpoint-dir", str(ckpt),
                      "--optimizer", "adam8bit",
                      "--profile", str(tmp_path / "prof")])
    want_family = "llama" if family == "llama" else "moe"
    assert r["family"] == want_family and r["unit"] == "B params"
    assert r["rope_scaling"] is (family == "llama")
    assert (tmp_path / "prof" / "convert.trace.json").exists()
    cfg = tconvert.cfg_from_json((ckpt / "cfg.json").read_text())
    assert tconvert.family(cfg) == want_family
    r = _cli(capsys, ["train", "--preset", "tiny", "--steps", "2",
                      "--batch", "2", "--seq-len", "32",
                      "--optimizer", "adam8bit",
                      "--checkpoint-dir", str(ckpt)])
    assert r["resumed_from"] == 0
    assert r["metric"].startswith(want_family + ":")
    # the first step's loss is the imported weights' loss on the first
    # batch (train's fixed synthetic batch, drawn as train draws it)
    params, _ = tconvert.load_hf_checkpoint(str(tmp_path / "hf"),
                                            device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 33),
                           generator=torch.Generator().manual_seed(1))
    loss_fn = tllama.loss_fn if family == "llama" else tmoe.loss_fn
    with torch.no_grad():
        assert r["first_loss"] == loss_fn(params, tokens, cfg).item()
    assert r["final_loss"] < r["first_loss"]

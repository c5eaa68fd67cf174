"""The workload CLI's sharded checkpoints on gloo ranks: ``workload train
--optimizer adam8bit --checkpoint-dir`` on a 2-rank mesh, resumed, ends
where an uninterrupted run ends (dense and MoE); and ``workload convert
--tensor 2`` over a 2-rank bootstrap world writes a sharded step-0
checkpoint that ``train --tensor 2`` resumes.

The trains run inside one spawned 2-rank world (``run_ranks``, the CLI's
``main`` in each rank over its gloo group); ``convert`` runs as the agent
starts a job, one process a rank from a bootstrap file.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from test_torch_dist_attention import (free_port, retry_on_taken_port,
                                       run_ranks)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the first train step after convert: a fixed synthetic batch
FIRST = ["train", "--optimizer", "adam8bit", "--steps", "1", "--batch", "2",
         "--seq-len", "16"]


def _main(argv) -> dict:
    """``workload`` main in this process; its JSON line."""
    from tpu_network_operator_torch.workload import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _bootstrap_world(path, argv) -> list:
    """``workload`` ``argv`` on 2 processes of one host from the bootstrap
    file ``path`` (the agent's schema: one process entry, 2 chips, so
    ``LOCAL_RANK`` picks the rank): each rank's JSON line."""
    return retry_on_taken_port(lambda _: _bootstrap_once(path, argv))


def _bootstrap_once(path, argv) -> list:
    path.write_text(json.dumps({
        "version": 1, "coordinator_address": f"127.0.0.1:{free_port()}",
        "num_processes": 1, "process_id": 0,
        "topology": {"num_chips": 2, "chips_per_host": 2, "num_slices": 1},
    }))
    procs = []
    for rank in range(2):
        env = {**os.environ, "LOCAL_RANK": str(rank),
               "LOCAL_WORLD_SIZE": "2", "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpu_network_operator_torch.workload",
             *argv, "--device", "cpu", "--bootstrap", str(path)],
            cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    lines = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            lines.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return lines


def write_hf_llama(directory) -> None:
    """A tiny HF Llama checkpoint written by hand (no ``transformers``):
    ``config.json`` and one f32 ``model.safetensors`` of seeded random
    weights, each projection stored ``[out, in]``."""
    hidden, ffn, layers, heads, kv = 64, 128, 2, 4, 2
    config = dict(model_type="llama", vocab_size=256, hidden_size=hidden,
                  intermediate_size=ffn, num_hidden_layers=layers,
                  num_attention_heads=heads, num_key_value_heads=kv,
                  max_position_embeddings=128, tie_word_embeddings=False)
    rng = np.random.default_rng(3)
    d = hidden // heads

    def w(out, inp):
        return (rng.standard_normal((out, inp)) / np.sqrt(inp)).astype(
            np.float32)

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(hidden)).astype(np.float32)

    tensors = {"model.embed_tokens.weight": w(256, hidden)}
    for i in range(layers):
        pre = f"model.layers.{i}."
        tensors.update({
            pre + "self_attn.q_proj.weight": w(heads * d, hidden),
            pre + "self_attn.k_proj.weight": w(kv * d, hidden),
            pre + "self_attn.v_proj.weight": w(kv * d, hidden),
            pre + "self_attn.o_proj.weight": w(hidden, heads * d),
            pre + "mlp.gate_proj.weight": w(ffn, hidden),
            pre + "mlp.up_proj.weight": w(ffn, hidden),
            pre + "mlp.down_proj.weight": w(hidden, ffn),
            pre + "input_layernorm.weight": norm(),
            pre + "post_attention_layernorm.weight": norm()})
    tensors["model.norm.weight"] = norm()
    tensors["lm_head.weight"] = w(256, hidden)
    header, off = {"__metadata__": {"format": "pt"}}, 0
    for name, a in tensors.items():
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [off, off + a.nbytes]}
        off += a.nbytes
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    directory.mkdir()
    (directory / "config.json").write_text(json.dumps(config))
    (directory / "model.safetensors").write_bytes(
        len(h).to_bytes(8, "little") + h
        + b"".join(a.tobytes() for a in tensors.values()))


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The tiny HF Llama checkpoint converted over a 2-rank bootstrap
    world (``--tensor 2``) and in one process; each rank's JSON line, and
    the one-process import's first train step."""
    root = tmp_path_factory.mktemp("convert")
    write_hf_llama(root / "hf")
    convert = ["convert", "--optimizer", "adam8bit", "--hf-path",
               str(root / "hf")]
    lines = _bootstrap_world(root / "jax-coordinator.json", [
        *convert, "--tensor", "2", "--checkpoint-dir", str(root / "mesh")])
    _main([*convert, "--device", "cpu", "--checkpoint-dir",
           str(root / "one")])
    shutil.copytree(root / "one", root / "one_on_mesh")
    one = _main([*FIRST, "--device", "cpu", "--checkpoint-dir",
                 str(root / "one")])
    return dict(root=root, lines=lines, one=one,
                listing=sorted(os.listdir(root / "mesh")))


def workload_rank(rank, world, directory, root):
    """On a 2-rank mesh (fsdp 2; the MoE over expert 2): 3 steps at once,
    and 2 steps then a resume for 1 more, from one token file; then one
    ``--tensor 2`` step from each converted checkpoint."""
    data = os.path.join(directory, "tokens.bin")
    out = {}
    for model, flags in (("llama", []), ("moe", ["--expert", "2"])):
        base = ["train", "--device", "cpu", "--preset", "tiny", "--model",
                model, *flags, "--optimizer", "adam8bit", "--data", data,
                "--batch", "4", "--seq-len", "16"]
        out[model] = {
            name: _main([*base, "--steps", str(steps), "--checkpoint-dir",
                         os.path.join(directory, model, ckpt)])
            for name, steps, ckpt in (("whole", 3, "whole"),
                                      ("first", 2, "split"),
                                      ("resumed", 1, "split"))}
    for name in ("mesh", "one_on_mesh"):
        out[name] = _main([*FIRST, "--device", "cpu", "--tensor", "2",
                           "--checkpoint-dir", os.path.join(root, name)])
    return out


@pytest.fixture(scope="module")
def workload_runs(converted, tmp_path_factory):
    directory = tmp_path_factory.mktemp("workload")
    np.random.default_rng(0).integers(0, 256, 20_000, dtype=np.uint16).tofile(
        directory / "tokens.bin")
    return run_ranks(2, workload_rank, str(directory), str(converted["root"]),
                     store_dir=tmp_path_factory.mktemp("store"))


@pytest.mark.parametrize("model", ["llama", "moe"])
def test_resumed_workload_train_on_a_mesh_ends_where_uninterrupted(
        model, workload_runs):
    """3 steps, against 2 and a resume for 1 more on the same mesh: the
    batches restart at the restored step and the CPU ops are
    deterministic, so the final losses are equal, on both ranks."""
    ranks = [r[model] for r in workload_runs]
    assert ranks[0]["resumed"]["final_loss"] == \
        ranks[1]["resumed"]["final_loss"]
    runs = ranks[0]
    assert runs["whole"]["resumed_from"] == 0
    assert runs["resumed"]["resumed_from"] == 2
    assert runs["resumed"]["mesh"]["devices"] == 2
    assert runs["resumed"]["final_loss"] == runs["whole"]["final_loss"]


def test_convert_over_a_mesh_then_train_resumes_at_step_0(converted,
                                                          workload_runs):
    """``convert --tensor 2`` over the bootstrap world writes step 0 and
    the sidecar; ``train --tensor 2`` resumes it at step 0 with exactly
    the first loss of the same train resumed from the one-process convert
    (the same bits restored), and within half a bf16 ulp (2**-9 relative)
    of the one-process import's first loss: ``convert`` imports in bf16,
    as the reference's does, and the tensor-parallel partial sums of wo
    and w_down round to bf16 before their all-reduce where one device
    rounds each sum once (4.9e-4 relative measured on this checkpoint; in
    f32 the two losses of these weights are the same bits, and the f32
    mesh steps are held to 1e-5 in ``test_torch_dist_train.py``)."""
    assert all(line["mesh"]["tensor"] == 2 and line["mesh"]["devices"] == 2
               for line in converted["lines"])
    assert converted["listing"] == ["0", "cfg.json"]
    one = converted["one"]
    assert one["resumed_from"] == 0 and one["mesh"]["devices"] == 1
    for rank in workload_runs:
        mesh, one_on_mesh = rank["mesh"], rank["one_on_mesh"]
        assert mesh["resumed_from"] == 0 and mesh["mesh"]["tensor"] == 2
        assert one_on_mesh["resumed_from"] == 0
        assert mesh["first_loss"] == one_on_mesh["first_loss"]
        assert abs(mesh["first_loss"] - one["first_loss"]) <= \
            2.0 ** -9 * abs(one["first_loss"])

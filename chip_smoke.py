"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device: the torch device and ``nvidia-smi``'s name and power limit;
2. build: compile the CUDA kernels from ``tpu_network_operator_torch/ops/
   csrc`` (one ``nvcc`` per source, in parallel);
3. kernels: each kernel against its plain PyTorch version on the card;
4. generate: greedy ``generate`` of ``llama3-1b`` at full width and depth
   (random bf16 weights from a seeded CUDA generator), batch 64, prompt
   128, 256 new tokens, with the kernels' launch counts read from that run;
5. card_vs_cpu: the same bf16 weights (``llama3-1b`` widths, 2 layers) on
   the card (kernels) and on the CPU (plain versions);
6. the kernel table: each kernel's time at the serving path's shapes beside
   its bound, its plain version's time and one PyTorch library call's.

The second-to-last line is ``nvidia-smi``'s ``name, power.limit``; the
last is ``{"ok": true, "device": {...}}``.  Needs one CUDA GPU and exits
non-zero without one, printing no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from tpu_network_operator_torch.models.generate import (  # noqa: E402
    forward_with_cache,
    generate,
    init_cache,
)
from tpu_network_operator_torch.models.llama import (  # noqa: E402
    LlamaConfig,
    init_params,
    params_to,
)
from tpu_network_operator_torch.ops import _kernels  # noqa: E402
from tpu_network_operator_torch.ops import flash_attention as fa  # noqa: E402
from tpu_network_operator_torch.ops import norms  # noqa: E402

BATCH, PROMPT, NEW_TOKENS = 64, 128, 256
SEED = 0

# published dense peaks per SKU: (device memory B/s, bf16 tensor FLOP/s,
# f32 non-tensor FLOP/s) -- NVIDIA data sheets
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100": (3.35e12, 989e12, 67e12),          # SXM5 80GB HBM3
}

# kernel vs plain on the card.  RMSNorm: both take the f32 sum of squares
# in different orders and rsqrtf is approximate, which can flip one bf16
# rounding of y (2^-8 relative).  Flash: the kernel tiles at 64x64 and the
# plain version is run with the same blocking; f32 sums in other orders
# and expf can flip one bf16 rounding of p or O.
RMS_TOL = {"rtol": 1e-2, "atol": 1e-2}
FLASH_O_ATOL = 2e-2
FLASH_LSE_ATOL = 1e-4
# card vs CPU, bf16 through 2 full-width layers: normalized max deviation
# (the JAX flash suite's discipline for bf16 op-ordering differences)
LOGITS_MAX_REL = 5e-2


def emit(payload: dict) -> None:
    print(json.dumps(payload), flush=True)


def fail(msg: str) -> None:
    emit({"error": msg})
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    fail(f"no published peaks for {name!r}")


def time_ms(fn, iters: int = 20, reps: int = 11) -> float:
    """Device time of one call: ``iters`` back-to-back calls are captured
    in a CUDA graph (so the host's Python and launch overhead is not in
    the number), the graph is replayed ``reps`` times between CUDA events
    after a warm-up, and the median per-call time is returned."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(samples)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


# -- phases -------------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        raise SystemExit(2)
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi})
    return name, smi


def phase_build():
    t0 = time.perf_counter()
    path = _kernels.build()
    _kernels.lib()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "library": path.name})


def _rms_case(shape, gen):
    x = (torch.randn(shape, device="cuda", generator=gen) * 2).bfloat16()
    s = (torch.randn(shape[-1], device="cuda", generator=gen) + 1).bfloat16()
    return x, s


def _flash_case(b, h, hkv, s, d, gen):
    def rnd(heads):
        return torch.randn(b, s, heads, d, device="cuda",
                           generator=gen).bfloat16()
    return rnd(h), rnd(hkv), rnd(hkv)


def _flash_plain_bshd(q, k, v, causal):
    o, lse = fa._flash_fwd_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        block_q=64, block_k=64, causal=causal)
    return o.transpose(1, 2), lse


def phase_kernels():
    gen = torch.Generator("cuda").manual_seed(SEED)
    for shape in [(64, 2048), (8192, 2048), (5, 4096)]:
        x, s = _rms_case(shape, gen)
        y, rstd = norms.fused_rms_norm(x, s, 1e-5)
        torch.cuda.synchronize()
        ref = norms._rms_norm_plain(x, s, 1e-5)
        ref_rstd = torch.rsqrt(x.float().square().mean(-1) + 1e-5)
        err = max_err(y, ref)
        ok = torch.allclose(y.float(), ref.float(), **RMS_TOL) and \
            torch.allclose(rstd, ref_rstd, rtol=1e-5, atol=0)
        emit({"phase": "kernels", "kernel": "rms_norm_fwd",
              "shape": list(shape), "max_abs_err": err, "tol": RMS_TOL,
              "ok": ok})
        check(ok, f"rms_norm_fwd disagrees with its plain version at {shape}")
    cases = [(2, 32, 8, s, 64, c) for s in (128, 1024) for c in (True, False)]
    cases.append((2, 16, 4, 512, 128, True))
    for b, h, hkv, s, d, causal in cases:
        q, k, v = _flash_case(b, h, hkv, s, d, gen)
        o, lse = fa._flash_fwd_kernel(q, k, v, causal=causal, seq_dim=1,
                                      head_dim=2)
        torch.cuda.synchronize()
        ro, rlse = _flash_plain_bshd(q, k, v, causal)
        err_o, err_l = max_err(o, ro), max_err(lse, rlse)
        ok = err_o <= FLASH_O_ATOL and err_l <= FLASH_LSE_ATOL
        emit({"phase": "kernels", "kernel": "flash_fwd",
              "shape": [b, s, h, hkv, d], "causal": causal,
              "max_abs_err_o": err_o, "max_abs_err_lse": err_l,
              "tol": {"o": FLASH_O_ATOL, "lse": FLASH_LSE_ATOL}, "ok": ok})
        check(ok, f"flash_fwd disagrees with its plain version at "
                  f"{(b, h, hkv, s, d, causal)}")


def profile_decode(params, cfg, cache, tok, steps: int = 32) -> dict:
    """torch.profiler over ``steps`` greedy decode steps after a prefill:
    wall time per step, the device's busy share (sum of kernel times over
    wall time; one stream, so kernels do not overlap) and the kernels that
    take the most device time.  The profiler's own host cost is inside
    the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode(), profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            logits, _ = forward_with_cache(params, tok[:, None].long(), cache,
                                           PROMPT + i, cfg, attn_len=256)
            tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): a CPU op's device time
    # would count its kernels a second time
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "steps": steps,
        "step_ms": wall_us / steps / 1e3,
        "device_busy_share": busy_us / wall_us if busy_us else None,
        "device_ms_per_step": busy_us / steps / 1e3 if busy_us else None,
        "top_kernels": [
            {"name": e.key[:80], "calls_per_step": e.count / steps,
             "ms_per_step": e.self_device_time_total / steps / 1e3}
            for e in top
        ],
    }


def phase_generate():
    cfg = LlamaConfig.llama3_1b()
    gen = torch.Generator("cuda").manual_seed(SEED)
    params = init_params(cfg, gen, "cuda")
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device="cuda",
                           generator=gen)
    forward_calls = NEW_TOKENS        # one prefill + NEW_TOKENS - 1 steps

    def drive():
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(params, prompt, cfg, NEW_TOKENS)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(_kernels.LAUNCHES)

    out, first_s, _ = drive()
    out, dt, launches = drive()

    # prefill alone, then a profiled window of decode steps, for the
    # breakdown (outside the counted run)
    cache = init_cache(cfg, BATCH, PROMPT + NEW_TOKENS, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, _ = forward_with_cache(params, prompt, cache, 0, cfg,
                                       attn_len=PROMPT)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    profile = profile_decode(params, cfg, cache, logits[:, -1].argmax(-1))
    del cache, logits

    check(tuple(out.shape) == (BATCH, PROMPT + NEW_TOKENS),
          f"generate returned shape {tuple(out.shape)}")
    check(bool(torch.equal(out[:, :PROMPT].long(), prompt)),
          "generate did not keep the prompt")
    check(int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
          "generated ids outside the vocabulary")
    want = {"flash_fwd": cfg.layers,
            "rms_norm_fwd": (2 * cfg.layers + 1) * forward_calls}
    check(launches == want, f"kernel launches {launches}, expected {want}")
    emit({"phase": "generate", "preset": "llama3-1b", "layers": cfg.layers,
          "params": cfg.num_params(), "batch": BATCH, "prompt": PROMPT,
          "new_tokens": NEW_TOKENS,
          "tokens_per_s": BATCH * NEW_TOKENS / dt,
          "seconds": dt, "first_call_seconds": first_s,
          "prefill_ms": prefill_s * 1e3,
          "decode_step_ms": (dt - prefill_s) / (NEW_TOKENS - 1) * 1e3,
          "launches": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "out_shape": list(out.shape)})
    emit({"phase": "profile_decode", **profile})
    del params
    torch.cuda.empty_cache()
    return launches


def phase_card_vs_cpu():
    cfg = LlamaConfig(hidden=2048, layers=2, heads=32, kv_heads=8, ffn=8192)
    params_gpu = init_params(
        cfg, torch.Generator("cuda").manual_seed(SEED + 1), "cuda")
    params_cpu = params_to(params_gpu, "cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, PROMPT),
                           generator=torch.Generator().manual_seed(SEED + 2))
    logits = {}
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        cache = init_cache(cfg, 2, PROMPT + 8, device=dev)
        with torch.inference_mode():
            lg, _ = forward_with_cache(params, prompt.to(dev), cache, 0, cfg,
                                       attn_len=PROMPT)
        logits[dev] = lg[:, -1].float().cpu()
    out_cpu = generate(params_cpu, prompt, cfg, 8)
    out_gpu = generate(params_gpu, prompt.cuda(), cfg, 8).cpu()
    ref = logits["cpu"]
    rel = max_err(logits["cuda"], ref) / ref.abs().max().clamp_min(1e-3).item()
    top2 = torch.topk(ref, 2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).min().item()
    first_equal = bool(torch.equal(out_cpu[:, PROMPT], out_gpu[:, PROMPT]))
    agree = (out_cpu[:, PROMPT:] == out_gpu[:, PROMPT:]).float().mean().item()
    emit({"phase": "card_vs_cpu", "layers": cfg.layers, "batch": 2,
          "logits_max_rel": rel, "tol": LOGITS_MAX_REL,
          "top1_margin_cpu": margin, "first_token_equal": first_equal,
          "token_agreement": agree})
    check(rel < LOGITS_MAX_REL, f"card vs CPU step-0 logits: {rel}")
    check(first_equal, "card vs CPU: first greedy token differs")


def phase_table(name: str, launches: dict):
    bw, bf16_peak, f32_peak = peaks(name)
    gen = torch.Generator("cuda").manual_seed(SEED + 3)
    cfg = LlamaConfig.llama3_1b()
    rows = []

    def rms_entry(n_rows):
        x, s = _rms_case((n_rows, cfg.hidden), gen)
        y, _ = norms.fused_rms_norm(x, s, cfg.rms_eps)
        ref = norms._rms_norm_plain(x, s, cfg.rms_eps)
        check(torch.allclose(y.float(), ref.float(), **RMS_TOL),
              f"rms_norm_fwd disagrees with its plain version at {n_rows} rows")
        err = max_err(y, ref)
        nbytes = 2 * x.numel() * 2 + s.numel() * 2 + n_rows * 4
        flops = 4 * x.numel()
        t_bytes, t_ops = nbytes / bw * 1e3, flops / f32_peak * 1e3
        return {
            "shape": [n_rows, cfg.hidden],
            "max_abs_err": err,
            "ms": time_ms(lambda: norms.fused_rms_norm(x, s, cfg.rms_eps)),
            "plain_ms": time_ms(
                lambda: norms._rms_norm_plain(x, s, cfg.rms_eps)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(lambda: torch.nn.functional.rms_norm(
                x, (cfg.hidden,), s, cfg.rms_eps)),
        }

    prefill = rms_entry(BATCH * PROMPT)
    decode = rms_entry(BATCH)
    rows.append({
        "name": "rms_norm_fwd", "route": "cuda",
        "source": "tpu_network_operator_torch/ops/csrc/rms_norm_fwd.cu",
        "replaces": "tpu_network_operator/ops/norms.py:91",
        "launches": launches["rms_norm_fwd"],
        **prefill, "decode": decode,
    })

    b, h, hkv, s, d = BATCH, cfg.heads, cfg.kv_heads, PROMPT, cfg.head_dim
    q, k, v = _flash_case(b, h, hkv, s, d, gen)
    o, lse = fa._flash_fwd_kernel(q, k, v, causal=True, seq_dim=1,
                                  head_dim=2)
    ro, rlse = _flash_plain_bshd(q, k, v, True)
    err = max_err(o, ro)
    check(err <= FLASH_O_ATOL and max_err(lse, rlse) <= FLASH_LSE_ATOL,
          "flash_fwd disagrees with its plain version at the prefill shape")
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + b * h * s * 4
    pairs = s * (s + 1) // 2            # causal (q, k) pairs per head
    flops = 4 * d * pairs * b * h       # QK^T and PV over the causal pairs
    t_bytes, t_ops = nbytes / bw * 1e3, flops / bf16_peak * 1e3
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rows.append({
        "name": "flash_fwd", "route": "cuda",
        "source": "tpu_network_operator_torch/ops/csrc/flash_fwd.cu",
        "replaces": "tpu_network_operator/ops/pallas_attention.py:67",
        "launches": launches["flash_fwd"],
        "shape": [b, s, h, hkv, d], "max_abs_err": err,
        "ms": time_ms(lambda: fa._flash_fwd_kernel(
            q, k, v, causal=True, seq_dim=1, head_dim=2)),
        "plain_ms": time_ms(lambda: _flash_plain_bshd(q, k, v, True),
                            iters=3, reps=5),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
    })
    emit({"kernels": rows})


def main() -> int:
    name, smi = phase_device()
    phase_build()
    phase_kernels()
    launches = phase_generate()
    phase_card_vs_cpu()
    phase_table(name, launches)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

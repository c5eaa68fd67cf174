"""Why a dropless MoE cell's first gradients part from the reference's: the
experts each side routes to.

    python3 -m portbench.calibrate_routes --workload <cell> --seed <n>

Runs the cell's first train step as a run does, at its own size, once on
each side as it routes and once on each side routed as the other side
routed, and prints one JSON line of:

* ``routes_differ``: each layer's share of tokens whose top-k experts
  differ between the program (bf16 hidden states) and the reference
  (float32 throughout) on the first batch, and the share of the B·S·k
  assignments that differ;
* ``median_grad_diff`` (the cell's number, each leaf's norm of the first
  gradients' difference over the reference's, the median leaf) and each
  leaf's, read three ways: ``as_run``, each side with its own routes (the
  run's reading); ``reference_on_program_routes``, the reference taking
  the program's experts (its own probabilities and gates); and
  ``program_on_reference_routes``, the program taking the reference's.

Where the forced readings fall to the dense cells' level while the run's
does not, the routes part the two sides and nothing else does.  A layer is
known by its router leaf's address, numbered in the order the forward
meets it.  The benchmark's own runs never do any of this.
"""

from __future__ import annotations

from portbench.common import Clock, pin_caches

CLOCK = Clock()
pin_caches()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from typing import Dict, Optional  # noqa: E402

import torch  # noqa: E402

from portbench import weights  # noqa: E402
from portbench.drivers import train, train_hybrid  # noqa: E402
from portbench.reference import hybrid_moe as reference  # noqa: E402
from portbench.run import Context  # noqa: E402


class Routes:
    """Each layer's top-k experts in one step: recorded, or, given
    ``forced`` (another side's record), imposed."""

    def __init__(self, forced: Optional[Dict[int, torch.Tensor]] = None):
        self.forced = forced
        self.got: Dict[int, torch.Tensor] = {}
        self.layers: Dict[int, int] = {}
        self.current = -1

    @contextlib.contextmanager
    def on(self, module, ffn: str, top_k: str):
        """Route ``module``'s sparse FFN ``ffn`` (called as ``ffn(cfg, lp,
        ...)``) through this record at its top-k function ``top_k``."""
        old_ffn, old_top = getattr(module, ffn), getattr(module, top_k)

        def ffn_at(cfg, lp, *args):
            key = lp["router"].data_ptr()
            self.current = self.layers.setdefault(key, len(self.layers))
            return old_ffn(cfg, lp, *args)

        def top(probs, k):
            if self.forced is not None:
                return self.forced[self.current].to(probs.device).reshape(
                    *probs.shape[:-1], k)
            idx = old_top(probs, k)
            self.got.setdefault(self.current, idx.reshape(-1, k).cpu())
            return idx

        setattr(module, ffn, ffn_at)
        setattr(module, top_k, top)
        try:
            yield self
        finally:
            setattr(module, ffn, old_ffn)
            setattr(module, top_k, old_top)


def program_first(ctx, routes: Routes):
    """(the step-1 gradients as the run reads them, the step's loss) of the
    program under ``routes``."""
    from tpu_network_operator_torch.models import moe

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    pcfg = train_hybrid.port_config(cfg, tr)
    step, _, opt = moe.make_train_step(
        pcfg, optimizer=train.port_optimizer(tr), device=dev)
    params = weights.draw(reference.leaf_view(cfg), ctx.seed, dev)
    state = opt.init(params)
    batch = weights.token_rows(ctx.seed, tr["pool"], tr["batch"],
                               tr["seq"] + 1, cfg["vocab_size"], dev)[0]
    with routes.on(moe, "_dropless_ffn", "top_k_experts"):
        params, state, loss = step(params, state, batch)
    _, first = train.first_grads(tr, state)
    loss = float(loss)
    del params, state, step, opt, batch
    ctx.free_device()
    return first, loss


def reference_first(ctx, routes: Routes, against, keep_first: bool):
    """``reference.follow``'s one-step readings under ``routes``."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    batches = weights.token_rows(ctx.seed, tr["pool"], tr["batch"],
                                 tr["seq"] + 1, cfg["vocab_size"], dev)[:1]
    with routes.on(reference, "moe_ffn", "experts_of"):
        got = reference.follow(cfg, ctx.seed, batches, tr["optimizer"],
                               tr["lr"], tr["weight_decay"], dev, 1,
                               chunk=tr["xent_chunk"], keep_first=keep_first,
                               against=against)
    ctx.free_device()
    return got


def grad_diffs(got: Dict, want: Dict, device) -> Dict[str, float]:
    """Each leaf's ||got - want|| / ||want|| over its slices (both
    {(leaf, slice): tensor}, as ``train.first_grads`` keys them)."""
    num, den = defaultdict(float), defaultdict(float)
    for key, w in want.items():
        w = w.to(device).double()
        num[key[0]] += float((got[key].to(device).double() - w).pow(2).sum())
        den[key[0]] += float(w.pow(2).sum())
    return {n: math.sqrt(num[n] / den[n]) if den[n] else 0.0 for n in den}


def routes_differ(a: Dict[int, torch.Tensor], b: Dict[int, torch.Tensor],
                  experts: int) -> Dict[str, list]:
    """Per layer, the share of tokens whose expert sets differ and the
    share of assignments one side makes and the other does not."""
    tokens, assignments = [], []
    for layer in sorted(a):
        x, y = a[layer], b[layer]
        n, k = x.shape
        sx = torch.zeros(n, experts, dtype=torch.bool).scatter_(1, x, True)
        sy = torch.zeros(n, experts, dtype=torch.bool).scatter_(1, y, True)
        same = (sx & sy).sum(1)
        tokens.append(float((same < k).float().mean()))
        assignments.append(float((k - same).sum()) / (n * k))
    return {"tokens": tokens, "assignments": assignments}


def witness(ctx) -> Dict:
    as_run = Routes()
    prog, prog_loss = program_first(ctx, as_run)
    ref_routes = Routes()
    ref = reference_first(ctx, ref_routes, [prog], keep_first=True)
    forced_ref = reference_first(ctx, Routes(as_run.got), [prog], False)
    del prog
    prog_on_ref, _ = program_first(ctx, Routes(ref_routes.got))
    diffs = {"as_run": ref["grad_diffs"][0],
             "reference_on_program_routes": forced_ref["grad_diffs"][0],
             "program_on_reference_routes": grad_diffs(
                 prog_on_ref, ref["first"], ctx.device)}
    return {"workload": ctx.name, "seed": ctx.seed,
            "losses": {"program": prog_loss, "reference": ref["losses"][0],
                       "reference_on_program_routes":
                           forced_ref["losses"][0]},
            "routes_differ": routes_differ(as_run.got, ref_routes.got,
                                           ctx.config["num_experts"]),
            "median_grad_diff": {k: statistics.median(v.values())
                                 for k, v in diffs.items()},
            "leaf_grad_diff": diffs,
            "limit": ctx.limits.get("median_grad_diff")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ctx = Context(args.workload, args.seed, 0.0, False, device=args.device,
                  clock=CLOCK)
    if ctx.cell["driver"] != "train_hybrid":
        print(f"portbench: {args.workload} routes no dropless MoE",
              file=sys.stderr)
        return 2
    print(json.dumps(witness(ctx)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

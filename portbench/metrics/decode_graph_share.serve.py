"""Share of the traced calls' decode steps that ran as one CUDA graph
replay: the program's counters ``generate.graph_steps`` and
``generate.eager_steps`` (both traced calls, of 2 and of 2 +
``trace_steps`` new tokens), graph / (graph + eager).  None where the
program keeps neither counter."""

from portbench import spans

LAYER = "decode loop (host, models/generate.py)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "decode_tokens_per_s"


def read(t):
    if t.get("kind") != "decode":
        return None
    graph = spans.counter("generate.graph_steps")
    eager = spans.counter("generate.eager_steps")
    steps = (graph or 0) + (eager or 0)
    if not steps:
        return None
    return 100.0 * (graph or 0) / steps

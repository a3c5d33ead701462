"""Share of the student's traced eval calls that replayed a captured CUDA
graph: 100 x calls of the program's `runner.eval_graph` span (one a
replayed chunk, inside `runner.eval`) over calls of `runner.eval`. None
for a program without that span."""

from glnn_tpu_torch.utils import profiling


def read(ctx):
    totals = getattr(profiling, "span_totals", dict)()
    graph, evals = totals.get("runner.eval_graph"), totals.get("runner.eval")
    if ctx["role"] != "serve" or not graph or not evals:
        return None
    return 100.0 * graph[0] / evals[0]

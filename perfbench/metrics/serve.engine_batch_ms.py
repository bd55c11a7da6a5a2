"""Mean wall ms of one ``ServingEngine.search_batch`` call inside the
traced window (engine layer: serving/engine.py), from the benchmark's
spans on the engine instance."""

from perfbench.core.readers import traced_calls


def read(ctx):
    if ctx.get("kind") != "search":
        return None
    calls = traced_calls(ctx)
    if not calls:
        return None
    return 1e3 * sum(c[1] - c[0] for c in calls) / len(calls)

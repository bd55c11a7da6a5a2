"""Share of the traced serving window in which no device operation ran."""

from perfbench.core.readers import idle_pct


def read(ctx):
    return idle_pct(ctx) if ctx.get("kind") == "search" else None

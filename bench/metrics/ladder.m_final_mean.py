"""ladder.m_final_mean: mean adapted sketch size of the window's answers."""

from bench.readers import mean


def read(ctx):
    return mean(ctx.records.get("m_final", []))

"""exact_pairs_per_s: pairs exactly tested in the completed parts over the
window (its start to the end of the last part)."""


def read(ctx):
    done = [u for u in ctx.done if u.part is not None]
    if not done:
        return None
    return sum(u.pairs for u in done) / (ctx.window[1] - ctx.window[0])

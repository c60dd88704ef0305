"""trait_s: the window (its start to the end of the last trait) over the
traits completed in it, in a closed loop of one client."""


def read(ctx):
    done = ctx.done
    if ctx.traffic["unit"] != "trait" or not done:
        return None
    return (ctx.window[1] - ctx.window[0]) / len(done)

def read(ctx):
    return ctx["work"]["calls"] / ctx["window_s"]

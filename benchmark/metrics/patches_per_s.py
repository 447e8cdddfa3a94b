"""patches_per_s (host clock): every patch of the window's calls over the
window's time, first dispatch to the final synchronize."""


def read(ctx):
    w = ctx["window"]
    return w.patches / w.seconds

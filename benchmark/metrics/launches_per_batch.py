"""launches_per_batch (device trace): kernel launches a call, counted in the
traced window (copies and fills not counted)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.launches or not ctx["window"].calls:
        return None
    return tr.launches / ctx["window"].calls

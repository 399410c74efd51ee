"""Host time from the entry call to its return, before any wait, averaged
over the window's calls (the harness's own span around each call)."""


def read(ctx):
    records = ctx.window["records"]
    if not records:
        return None
    return 1e3 * sum(r[1] - r[0] for r in records) / len(records)

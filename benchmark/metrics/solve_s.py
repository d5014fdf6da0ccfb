"""The whole window over the solves completed in it."""


def read(rec):
    return rec["window_s"] / rec["units"] if rec["units"] else None

"""Tokens of every train step that completed in the window, over the whole
window (host clock): trial set-up, system-config switches and host gaps
count against it."""


def read(rec):
    return rec["tokens"] / rec["window_s"] if rec["window_s"] > 0 else None

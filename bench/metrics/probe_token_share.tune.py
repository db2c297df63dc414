"""Share of the window's tokens trained in PipeTune's probe epochs."""


def read(rec):
    t = rec.get("tune")
    if not t or not t["tokens"]:
        return None
    return t["probe_tokens"] / t["tokens"]

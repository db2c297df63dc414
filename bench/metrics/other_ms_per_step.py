"""Device ms a step of every kernel that is no GEMM, no B1-B3 and not the
optimizer's: norms, RoPE, casts, softmax and loss, MoE gathers and
scatters."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["steps"] or not t["class_n"].get("other"):
        return None
    return 1e3 * t["class_s"]["other"] / t["steps"]

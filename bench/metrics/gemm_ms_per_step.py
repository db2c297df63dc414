"""Device ms a step of matrix-product kernels (cuBLAS, CUTLASS; bf16 and
fp32)."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["steps"] or not t["class_n"].get("gemm"):
        return None
    return 1e3 * t["class_s"]["gemm"] / t["steps"]

"""Serve a small LM with batched requests on the PyTorch port: prefill +
batched decode loop.

    PYTHONPATH=src python examples/torch_serve_lm.py --requests 8 --gen 32 \\
        [--device cpu]

The job of ``examples/serve_lm.py`` on ``repro_torch``: the same ``serve-lm``
dense config (4 layers, d_model 256, 4 heads over 2 kv heads of 64, d_ff
1024, vocab 2048), fp32 parameters from the port's seeded ``init``, bf16
compute, prompts from ``numpy.random.default_rng(1)``. Prefill attention runs
the flash kernel (B1) on the card; greedy decode reads the bf16 KV cache. One
prefill and one decode step warm up first (``launch.serve.serve``), then both
are timed. Without a GPU the script raises unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.transformer import ModelConfig, SystemConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = device_lib.resolve(args.device)
    cfg = ModelConfig(name="serve-lm", family="dense", n_layers=4,
                      d_model=256, n_heads=4, n_kv_heads=2, d_ff=1024,
                      vocab=2048, head_dim=64)
    params = T.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    sys = SystemConfig()

    B, S, GEN = args.requests, args.prompt_len, args.gen
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S))).to(dev)
    res = serve.serve(params, prompts, cfg, sys, GEN)

    t_prefill, t_decode = res.prefill_ms / 1e3, res.decode_ms / 1e3
    print(f"served {B} requests: prompt {S} tokens, generated {GEN}")
    print(f"prefill: {t_prefill*1e3:.1f} ms "
          f"({B*S/t_prefill:,.0f} tok/s)")
    if GEN > 1:
        print(f"decode:  {t_decode*1e3:.1f} ms "
              f"({B*(GEN-1)/t_decode:,.0f} tok/s, "
              f"{t_decode/(GEN-1)*1e3:.2f} ms/token)")
    print(f"sample continuation (request 0): "
          f"{res.tokens[0, :16].cpu().numpy()}")
    return res


if __name__ == "__main__":
    main()

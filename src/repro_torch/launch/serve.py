"""Serve an LM to batched requests: prefill, then greedy batched decode.

The counterpart of ``examples/serve_lm.py``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --requests 8 --prompt-len 2048 --gen 32 [--device cpu] [--seed 0]

Weights come from the port's ``init`` on a seeded ``torch.Generator`` (at the
compute dtype), prompts from ``numpy.random.default_rng(seed)``. One prefill
and one decode step warm up first; then prefill and decode are timed, with
CUDA events on the card and the host clock on the CPU. Without a GPU the
command raises unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as device_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as T


@dataclasses.dataclass
class ServeResult:
    cfg: T.ModelConfig
    sys: T.SystemConfig
    params: Any
    prompts: torch.Tensor          # (B, S)
    prefill_logits: torch.Tensor   # (B, 1, V) fp32, from the timed prefill
    tokens: torch.Tensor           # (B, gen) generated tokens
    prefills: int                  # prefill calls made (warm-up included)
    prefill_ms: float
    decode_ms: float
    device_name: str

    @property
    def prefill_tok_s(self) -> float:
        B, S = self.prompts.shape
        return B * S / (self.prefill_ms / 1e3)

    @property
    def decode_tok_s(self) -> float:
        B, gen = self.tokens.shape
        return B * (gen - 1) / (self.decode_ms / 1e3) if gen > 1 else 0.0


# family -> why ``serve`` cannot prefill and decode it; each of these
# serves through ``launch.steps``' prefill and decode builders.
_NOT_SERVABLE = {
    "hybrid": "serving a hybrid needs a prefill that hands its recurrent "
              "states to decode; the reference's forward(collect_cache="
              "True) returns only the attention caches, so its decode "
              "starts from init_cache (ROADMAP.md §C, 'On the reference "
              "side'). Run steps.make_prefill_step and make_decode_step "
              "from init_cache instead",
    "ssm": "an ssm's prefill hands decode no state at all: the reference's "
           "forward(collect_cache=True) returns None for the cache, so its "
           "decode starts from init_cache (ROADMAP.md §C, 'On the "
           "reference side'). Run steps.make_prefill_step and "
           "make_decode_step from init_cache instead",
    "vlm": "a vlm's prompts are patch embeddings (batch['embeddings']), "
           "not the token prompts this launcher makes. Run "
           "steps.make_prefill_step on {'embeddings': ...} and "
           "make_decode_step instead",
    "audio": "an encoder-decoder's prompts are frames plus tokens "
             "(batch['frames'], batch['tokens']), not the token prompts "
             "this launcher makes. Run steps.make_prefill_step and "
             "make_decode_step instead",
}


def require_servable(cfg) -> None:
    """Raise ``NotImplementedError``, saying why, for the families this
    launcher cannot serve (``_NOT_SERVABLE``): the hybrid and the ssm,
    whose prefill hands decode no recurrent state in the reference
    (ROADMAP.md §C), the vlm and the encoder-decoder, whose prompts are not
    tokens."""
    why = _NOT_SERVABLE.get(cfg.family)
    if why is not None:
        raise NotImplementedError(f"{cfg.name}: {why}")


def serve(params, prompts, cfg, sys, gen: int) -> ServeResult:
    """Warm up, then prefill ``prompts`` and decode ``gen`` tokens greedily
    (a hybrid, ssm, vlm or encoder-decoder raises first:
    ``require_servable``)."""
    require_servable(cfg)
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    dev = prompts.device
    B, S = prompts.shape
    prefill = steps_lib.make_prefill_step(cfg, sys, max_len=S + gen)
    decode = steps_lib.make_decode_step(cfg, sys)

    def next_token(logits):
        return logits[:, -1].argmax(-1)[:, None]

    logits, cache = prefill(params, {"tokens": prompts})      # warm-up
    decode(params, cache, next_token(logits), S)
    del cache

    with device_lib.Timer(dev) as t_prefill:
        logits, cache = prefill(params, {"tokens": prompts})
        tok = next_token(logits)
    out = [tok]
    with device_lib.Timer(dev) as t_decode:
        for i in range(gen - 1):
            step_logits, cache = decode(params, cache, tok, S + i)
            tok = next_token(step_logits)
            out.append(tok)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return ServeResult(cfg=cfg, sys=sys, params=params, prompts=prompts,
                       prefill_logits=logits, tokens=torch.cat(out, dim=1),
                       prefills=2, prefill_ms=t_prefill.ms,
                       decode_ms=t_decode.ms, device_name=name)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b",
                    help="arch id, or <arch>-reduced for the smoke config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def setup(args):
    """(cfg, sys, params, prompts) for parsed ``args``, on their device."""
    dev = device_lib.resolve(args.device)
    sys = T.SystemConfig()
    cfg = dataclasses.replace(configs.get(args.arch), dtype=sys.compute_dtype)
    require_servable(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init(gen, cfg, dev)
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (args.requests, args.prompt_len))
    return cfg, sys, params, torch.from_numpy(prompts).to(dev)


def main(argv: Optional[Sequence[str]] = None) -> ServeResult:
    args = parser().parse_args(argv)
    cfg, sys, params, prompts = setup(args)
    res = serve(params, prompts, cfg, sys, args.gen)
    B, S = prompts.shape
    print(f"served {B} requests of {cfg.name} on {res.device_name}: "
          f"prompt {S} tokens, generated {args.gen}")
    print(f"prefill: {res.prefill_ms:.3f} ms ({res.prefill_tok_s:,.0f} tok/s)")
    if args.gen > 1:
        print(f"decode:  {res.decode_ms:.3f} ms ({res.decode_tok_s:,.0f} "
              f"tok/s, {res.decode_ms / (args.gen - 1):.3f} ms/token)")
    print(f"sample continuation (request 0): "
          f"{res.tokens[0, :16].tolist()}")
    return res


if __name__ == "__main__":
    main()

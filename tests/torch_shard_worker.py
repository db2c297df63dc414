"""One rank of the port's sharded-step checks: ``tests/test_torch_sharded.py``
starts a group of these and reads what rank 0 writes.

    PYTHONPATH=src python tests/torch_shard_worker.py GROUP RANK WORLD OUT_DIR

The ranks of a group meet through a ``FileStore`` in OUT_DIR (no TCP port)
over gloo and give up after 60 s. OUT_DIR holds ``cases.json`` (the cases,
each with its group) and ``inputs.npz`` (each case's parameters as the
port's flattened leaves, from the reference's init, under the case's
``params`` key or its arch, and the tokens, labels, patch embeddings and
frames). A case's ``cfg`` replaces fields of its reduced config. For each case of its group, every rank:
  * places the parameters and an sgd state (momentum, global-norm clipping)
    on the case's mesh (``sharding.state_specs``) and the batch as the
    reference's ``NamedSharding`` would (``steps.distribute_batch``), takes
    one ``make_train_step(..., mesh=)`` step per microbatch count, and
    gathers the loss, the accuracy and every updated parameter whole;
  * with ``serve``, runs the prefill step on the placed parameters and
    ``DECODE_STEPS`` greedy decode steps from its cache, and for an MoE
    arch keeps the experts each layer of the prefill chose for each of its
    rows (``moe._gate``'s indices, gathered from every rank); a hybrid or
    an ssm (whose prefill hands decode no state, as the reference's)
    decodes the prompt's first ``DECODE_STEPS`` tokens from
    ``transformer.init_cache`` (fp32, placed by ``cache_specs``) instead,
    keeping every step's logits;
  * with ``fault`` "own_gates", runs the sLSTM with its gates taken from
    each rank's own columns of the pre-activations (a planted fault);
and rank 0 writes ``{case}.npz``.
"""
import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import configs, spmd, weights
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import moe, transformer, xlstm
from repro_torch.models.transformer import SystemConfig
from repro_torch.optim import optimizers

DECODE_STEPS = 3
LR = 0.1


def system(case, microbatches=1):
    """The case's sys: fp32, the reference's pins (batch axes, heads)."""
    baxes = ("pod", "data") if len(case["mesh"]) == 3 else ("data",)
    return SystemConfig(precision="fp32", q_chunk=16, kv_chunk=16,
                        use_pallas=case["pallas"], shard_attn=True,
                        batch_axes=baxes, microbatches=microbatches)


def optimizer():
    return optimizers.sgd(LR, momentum=0.9, clip_norm=1.0)


def whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def config(case):
    """The case's reduced config, with its ``cfg`` fields replaced."""
    return dataclasses.replace(configs.get_reduced(case["arch"]),
                               **case.get("cfg", {}))


def batch_of(cfg, inputs, kind="train"):
    """The family's batch from the inputs: tokens (a vlm's patch
    embeddings, whisper's frames and tokens), with labels to train."""
    fam = steps.family(cfg)
    keys = {"vlm": ["embeddings"], "audio": ["frames", "tokens"]}.get(
        fam, ["tokens"]) + (["labels"] if kind == "train" else [])
    out = {}
    for k in keys:
        t = torch.from_numpy(np.asarray(inputs[k]))
        out[k] = t.long() if k in ("tokens", "labels") else t
    return out


def own_gates(z, mesh, mesh_dim, size):
    """The planted sLSTM fault: z "made whole" from the rank's own columns
    (each gate then comes from the wrong channels)."""
    return torch.cat([z] * size, -1)


def recurrent(cfg) -> bool:
    return steps.family(cfg) in ("hybrid", "ssm")


def decode_from_init(cfg, sys_cfg, params, tokens, n, mesh=None):
    """``n`` decode steps from ``transformer.init_cache`` (fp32) over the
    first ``n`` columns of ``tokens`` (B, S): each step's logits whole."""
    cache = transformer.init_cache(cfg, tokens.shape[0], n,
                                   dtype=torch.float32, device="cpu")
    if mesh is not None:
        cache = steps.place(cache, sharding.cache_specs(cache, cfg, mesh),
                            mesh)
    decode = steps.make_decode_step(cfg, sys_cfg)
    out = []
    for t in range(n):
        tok = tokens[:, t:t + 1]
        if mesh is not None:
            tok = steps.distribute_batch({"t": tok}, mesh)["t"]
        logits, cache = decode(params, cache, tok, t)
        out.append(whole(logits).numpy())
    return np.stack(out)


def make_mesh(case):
    dims = case["mesh"]
    pods = dims[0] if len(dims) == 3 else 1
    return mesh_lib.make_mesh(dims[-2], dims[-1], pods=pods, device="cpu")


def run_case(case, inputs, out_dir, rank):
    gather = xlstm._gather_gates
    if case.get("fault") == "own_gates":
        xlstm._gather_gates = own_gates
    try:
        _run_case(case, inputs, out_dir, rank)
    finally:
        xlstm._gather_gates = gather


def _run_case(case, inputs, out_dir, rank):
    cfg = config(case)
    mesh = make_mesh(case)
    prefix = case.get("params", case["arch"]) + "/"
    flat = {k[len(prefix):]: torch.from_numpy(inputs[k])
            for k in inputs.files if k.startswith(prefix)}
    batch = batch_of(cfg, inputs)
    out = {}
    for m in case["micro"]:
        sys_cfg = system(case, m)
        opt = optimizer()
        params = weights.unflatten({p: t.clone() for p, t in flat.items()})
        state = {"params": params, "opt": opt.init(params), "step": 0}
        state = steps.place(state, sharding.state_specs(state, cfg, mesh,
                                                        sys_cfg), mesh)
        step = steps.make_train_step(cfg, sys_cfg, opt, mesh=mesh)
        state, metrics = step(state, steps.distribute_batch(batch, mesh))
        out[f"m{m}/loss"] = metrics["loss"].numpy()
        out[f"m{m}/accuracy"] = metrics["accuracy"].numpy()
        for p, t in weights.flatten(state["params"]).items():
            out[f"m{m}/params/{p}"] = whole(t).numpy()
        kinds = {type(t).__name__
                 for t in weights.flatten(state["params"]).values()}
        out[f"m{m}/all_dtensors"] = np.array(kinds == {"DTensor"})
    if case["serve"]:
        sys_cfg = system(case)
        params = steps.place(
            weights.unflatten(dict(flat)),
            sharding.param_specs(weights.unflatten(dict(flat)), cfg, mesh,
                                 sys_cfg), mesh)
        S = batch["labels"].shape[1]
        if recurrent(cfg):
            prompt = steps.distribute_batch(batch_of(cfg, inputs, "prefill"),
                                            mesh)
            logits, _ = steps.make_prefill_step(cfg, sys_cfg)(params, prompt)
            out["prefill_logits"] = whole(logits).numpy()
            out["decode_logits"] = decode_from_init(
                cfg, sys_cfg, params, batch["tokens"], DECODE_STEPS, mesh)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{case['name']}.npz"), **out)
            return
        prefill = steps.make_prefill_step(cfg, sys_cfg,
                                          max_len=S + DECODE_STEPS)
        decode = steps.make_decode_step(cfg, sys_cfg)
        prompt = steps.distribute_batch(batch_of(cfg, inputs, "prefill"),
                                        mesh)
        routes, gate = [], moe._gate

        def spy(x, *args):
            out = gate(x, *args)
            routes.append(out[1].numpy())
            return out
        moe._gate = spy
        try:
            logits, cache = prefill(params, prompt)
        finally:
            moe._gate = gate
        if routes:
            first = next(iter(prompt.values()))
            row0 = spmd._row_starts(mesh, first.placements, first.shape[0])
            pieces = [None] * dist.get_world_size()
            dist.all_gather_object(pieces, (row0, routes))
            for layer in range(len(routes)):
                whole_idx = np.zeros((first.shape[0],) + routes[0].shape[1:],
                                     np.int64)
                for start, rs in pieces:
                    whole_idx[start:start + len(rs[layer])] = rs[layer]
                out[f"routes/{layer}"] = whole_idx
        out["prefill_logits"] = whole(logits).numpy()
        tok = whole(logits).argmax(-1)
        toks = [tok]
        for i in range(DECODE_STEPS):
            logits, cache = decode(params, cache, steps.distribute_batch(
                {"t": tok}, mesh)["t"], S + i)
            tok = whole(logits).argmax(-1)
            toks.append(tok)
        out["tokens"] = torch.cat(toks, 1).numpy()
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{case['name']}.npz"), **out)


def main(group, rank, world, out_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, f"store_{group}"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    with open(os.path.join(out_dir, "cases.json")) as f:
        cases = [c for c in json.load(f) if c["group"] == group]
    inputs = np.load(os.path.join(out_dir, "inputs.npz"))
    for case in cases:
        run_case(case, inputs, out_dir, rank)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

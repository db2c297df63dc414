"""One rank of the port's 4-rank gloo checks:
``tests/test_torch_distributed.py`` starts four of these and reads what
they write.

    PYTHONPATH=src python tests/torch_dist_worker.py RANK WORLD OUT_DIR

The ranks meet through a ``FileStore`` in OUT_DIR (no TCP port, so parallel
test runs cannot collide) and give up after 60 s. Each rank:
  * reduces its slice of ``OUT_DIR/grads.npz`` with
    ``collectives.compressed_grad_mean`` (methods none and int8) and writes
    ``coll{rank}.npz``;
  * reshards a seeded reduced qwen3-0.6b train state (params, random adamw
    moments, step) from whole tensors onto the (4,1), (2,2) and (1,4) meshes
    in turn (``elastic.reshard_state``), and records every leaf's spec,
    local shard shape and whether ``full_tensor()`` equals the original bit
    for bit;
  * restores rank 0's checkpoint of that state onto the (2,2) mesh with
    ``placements=`` and records the same, and whether
    ``elastic.reshard_params`` puts the parameters there alike;
  * shards a (5, 2) tensor over ("pod", "data") on a (2,2,1) mesh (an uneven
    dim over two mesh dims) and records its local shape;
and writes ``rank{rank}.json``.
"""
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import checkpoint, configs, weights
from repro_torch.distributed import collectives, elastic, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer
from repro_torch.models.transformer import SystemConfig
from repro_torch.optim import optimizers
from repro_torch.tree import tree_map

SYS = SystemConfig(param_sharding="2d")


def seeded_state(cfg):
    gen = torch.Generator().manual_seed(0)
    params = transformer.init(gen, cfg, "cpu")
    opt = optimizers.adamw(1e-3).init(params)
    opt = tree_map(lambda t: torch.randn(t.shape, generator=gen), opt)
    return {"params": params, "opt": opt, "step": 3}


def leaf_report(state, want, mesh):
    """{path: [spec, local shape, full_tensor() equal bit for bit]}, plus
    this rank's coordinate on the mesh."""
    specs = weights.flatten(sharding.state_specs(state, None, mesh, SYS))
    want = weights.flatten(want)
    out = {}
    for path, leaf in weights.flatten(state).items():
        if not isinstance(leaf, DTensor):
            out[path] = [None, None, leaf == want[path]]
            continue
        full = leaf.full_tensor()
        out[path] = [specs[path], list(leaf.to_local().shape),
                     bool(full.dtype == want[path].dtype
                          and torch.equal(full, want[path]))]
    return {"coord": mesh.get_coordinate(), "shape": list(mesh.shape),
            "names": list(mesh.mesh_dim_names), "leaves": out}


def main(rank, world, out_dir):
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    report = {}
    grads = np.load(os.path.join(out_dir, "grads.npz"))
    local = {k: torch.from_numpy(grads[k][rank]) for k in grads.files}
    coll = {}
    for method in ("none", "int8"):
        out = collectives.compressed_grad_mean(local, method=method)
        coll.update({f"{method}/{k}": v.numpy() for k, v in out.items()})
    np.savez(os.path.join(out_dir, f"coll{rank}.npz"), **coll)

    cfg = configs.get_reduced("qwen3-0.6b")
    state = seeded_state(cfg)
    cur = state
    for dp, tp in ((4, 1), (2, 2), (1, 4)):
        m = mesh_lib.make_mesh(dp, tp, device="cpu")
        cur = elastic.reshard_state(cur, cfg, m, SYS)
        report[f"reshard_{dp}x{tp}"] = leaf_report(cur, state, m)

    ckpt = os.path.join(out_dir, "ckpt")
    if rank == 0:
        checkpoint.save_pytree(state, ckpt)
    dist.barrier()
    m22 = mesh_lib.make_mesh(2, 2, device="cpu")
    like = tree_map(lambda t: t.to("meta") if torch.is_tensor(t) else t,
                    state)
    places = sharding.named(sharding.state_specs(like, cfg, m22, SYS), m22)
    restored = checkpoint.load_pytree(ckpt, like, placements=places)
    report["restore_2x2"] = leaf_report(restored, state, m22)
    params = elastic.reshard_params(state["params"], cfg, m22, SYS)
    report["reshard_params_2x2"] = all(
        a.placements == b.placements and torch.equal(a.full_tensor(),
                                                      b.full_tensor())
        for a, b in zip(weights.flatten(params).values(),
                        weights.flatten(restored["params"]).values()))

    pods = mesh_lib.make_mesh(2, 1, pods=2, device="cpu")
    x = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    spec = (("pod", "data"), None)
    dx = sharding.named(spec, pods).distribute(x)
    report["uneven_pod_data"] = {
        "coord": pods.get_coordinate(), "shape": list(pods.shape),
        "names": list(pods.mesh_dim_names),
        "leaves": {"x": [spec, list(dx.to_local().shape),
                         torch.equal(dx.full_tensor(), x)]}}
    try:
        mesh_lib.make_production_mesh(device="cpu")
        report["production_mesh_refused"] = False
    except ValueError:
        report["production_mesh_refused"] = True
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])

"""Dry run: trace every (arch x workload x mesh) cell on meta tensors.

The counterpart of the reference's launch/dryrun.py.  Each cell builds
its step at the full configuration on the zone mesh and runs it once on
`device="meta"` tensors — shapes and dtypes, no bytes, no card — under
the cost mode (launch/cost.py), which records:

  * the step's flops, bytes, launches and hand-kernel calls (the zone's
    totals: one device holds every rank of the zone mesh),
  * the zone collectives' wire bytes, as each rank would send them,
  * the step's peak of live bytes on the one device, and each rank's
    argument bytes (what one card of the mesh would hold),
  * the roofline terms per device (the totals / n_devices) on the H100's
    peaks, and the trace's wall time.

Train cells trace the *protected* step, as the reference lowers it: the
train step on the global view of the zone-stacked state, the new state
zone-stacked again, and the Protector's commit program (`make_commit`) on
the abstract `ProtectedState`.  Prefill cells trace the forward to the
last position's logits; decode cells one token against a full cache.
The port's steps read nothing back to the host, so a meta trace runs them
as the card would; the two host values a step takes are host ints here
(the decode position, the redo log's data cursor).

Usage:
    python -m repro_torch.launch.dryrun \\
        [--arch ID|all] [--workload NAME|all] [--mesh single|multi|both]
        [--protect mlpc|mlp|ml|none|replica] [--out results.json]
        [--resume]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any

import torch

from repro_torch import utils
from repro_torch.configs import WORKLOADS, get_config, list_archs, \
    workload_skips
from repro_torch.configs.base import ProtectConfig, TrainConfig
from repro_torch.core import layout as layout_mod
from repro_torch.dist import sharding as shd
from repro_torch.launch import cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.models import params as prm
from repro_torch.models.transformer import build_model
from repro_torch.optim import build_optimizer
from repro_torch.pool import Pool

PyTree = Any

# per-arch gradient-accumulation factors for the train_4k cell, the
# reference's
MICROBATCHES = {
    "llama4-maverick-400b-a17b": 8,
    "chameleon-34b": 16,
    "minitron-8b": 8,
    "glm4-9b": 8,
    "moonshot-v1-16b-a3b": 8,
    "seamless-m4t-large-v2": 8,
    "recurrentgemma-2b": 4,
    "xlstm-1.3b": 4,
    "qwen2-0.5b": 4,
    "qwen3-0.6b": 4,
}


# -- the protected steps ------------------------------------------------------

def protected_train_step(model, optimizer, train_cfg, pool):
    """step(prot, batch) -> (prot', (loss, ok)): the train step on the
    global view of `prot.state`, then the commit of the new state, zone-
    stacked again, by the program of `pool`'s Protector."""
    train_step = api.make_train_step(model, optimizer, train_cfg)
    commit = pool.protector.make_commit()

    def step(prot, batch):
        new_state, metrics = train_step(pool.global_view(prot.state), batch)
        prot2, ok = commit(prot, pool.to_zone(new_state))
        return prot2, (metrics["loss"], ok)
    return step


def protected_serve_step(model, pool, max_len: int, pos: int):
    """step(params, token, prot) -> (prot', next token, ok): one decode
    step at `pos` on the global view of the cache in `prot`, then the
    patch commit of the time slot it wrote (the Server's synchronous
    step, its verdict left on the device)."""
    decode = api.make_decode_step(model)
    commit = pool.protector.make_commit(
        dirty_pages=layout_mod.time_slice_pages(
            pool.protector.layout, max_len, pos).tolist())

    def step(params, token, prot):
        tok, _, cache = decode(params, token, pool.global_view(prot.state),
                               pos)
        prot2, ok = commit(prot, pool.to_zone(cache))
        return prot2, tok, ok
    return step


# -- one cell -----------------------------------------------------------------

def rank_bytes(tree: PyTree, specs: PyTree, mesh) -> int:
    """Bytes one rank holds of global `tree` placed by `specs`."""
    return sum(math.prod(shd.local_shape(x.shape, s, mesh)) * x.element_size()
               for x, s in zip(utils.tree_leaves(tree),
                               utils.tree_leaves(specs)))


def tree_bytes(tree: PyTree) -> int:
    """Bytes of every tensor in `tree` (a ProtectedState's and a redo
    log's fields too)."""
    if dataclasses.is_dataclass(tree):
        return sum(tree_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return sum(x.numel() * x.element_size() if isinstance(x, torch.Tensor)
               else tree_bytes(x) if dataclasses.is_dataclass(x) else 0
               for x in utils.tree_leaves(tree))


def _analyze(counts: dict, n_dev: int, model_flops: float) -> dict:
    wire = {k: v / n_dev for k, v in counts["wire_bytes"].items()}
    total_wire = sum(wire.values())
    roof = cost.roofline_terms(counts["flops"] / n_dev,
                               counts["hbm_bytes"] / n_dev, total_wire,
                               model_flops=model_flops / n_dev)
    return {
        "cost": {"flops": counts["flops"], "mm_flops": counts["mm_flops"],
                 "hbm_bytes": counts["hbm_bytes"], "ops": counts["ops"],
                 "launches": counts["launches"],
                 "kernels": counts["kernels"]},
        "collectives": {"wire_bytes": wire, "counts": counts["wire_counts"],
                        "total_wire_bytes": total_wire},
        "roofline": dict(roof.as_dict(), device=cost.DEVICE),
    }


def dryrun_cell(arch: str, wl_name: str, multi_pod: bool,
                protect: str = "mlpc", verbose: bool = True) -> dict:
    """Trace one cell on meta; its record."""
    cfg = get_config(arch)
    wl = WORKLOADS[wl_name]
    skip = workload_skips(cfg, wl)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "workload": wl_name, "mesh": mesh_name,
           "protect": protect, "status": "skip" if skip else "run"}
    if skip:
        rec["skip_reason"] = skip
        return rec

    n_dev = math.prod(mesh.shape)
    model = build_model(cfg, mesh)
    n_params = api.count_params(cfg)
    n_active = api.count_params(cfg, active_only=True)
    t0 = time.perf_counter()
    if wl.kind == "train":
        train_cfg = TrainConfig(microbatches=MICROBATCHES.get(arch, 1))
        optimizer = build_optimizer(train_cfg, cfg)
        abstract_state = api.abstract_train_state(model, optimizer)
        specs = api.train_state_specs(model, optimizer, mesh)
        # a cold pool: the layout and the programs, no bytes
        pool = Pool(mesh, abstract_state, specs, ProtectConfig(mode=protect),
                    device="meta")
        protector = pool.protector
        step = protected_train_step(model, optimizer, train_cfg, pool)
        prot = protector.abstract_protected(abstract_state)
        batch = api.batch_abstract(cfg, wl)
        b_specs = api.batch_specs(cfg, mesh, wl.global_batch)
        zone_fields = [prot.synd, prot.cksums, prot.digest, prot.row]
        args_zone = tree_bytes(prot) + tree_bytes(batch)
        args_rank = (rank_bytes(abstract_state, specs, mesh)
                     + rank_bytes(batch, b_specs, mesh)
                     + sum(tree_bytes(f) for f in zone_fields) // n_dev
                     + tree_bytes(prot.log) + tree_bytes(prot.step))
        with cost.CostMode() as mode:
            out = step(prot, batch)
        model_flops = 6.0 * n_active * wl.global_batch * wl.seq_len
        rec["protection_overhead"] = protector.overhead_report()
    else:
        params = prm.abstract_params(model.param_defs())
        pspecs = model.param_specs(mesh)
        if wl.kind == "prefill":
            batch = api.batch_abstract(cfg, wl)
            b_specs = api.batch_specs(cfg, mesh, wl.global_batch)
            args_zone = tree_bytes(batch)
            args_rank = rank_bytes(batch, b_specs, mesh)
            with cost.CostMode() as mode:
                out = api.make_prefill(model)(params, batch)
            model_flops = 2.0 * n_active * wl.global_batch * wl.seq_len
        else:
            dec = api.decode_abstract(cfg, wl, model)
            dspecs = api.decode_specs(cfg, wl, model, mesh)
            inputs = {"token": dec["token"], "cache": dec["cache"]}
            ispecs = {"token": dspecs["token"], "cache": dspecs["cache"]}
            args_zone = tree_bytes(inputs)
            args_rank = rank_bytes(inputs, ispecs, mesh)
            # a full cache: the token at the last position attends to all
            with cost.CostMode() as mode:
                out = api.make_decode_step(model)(
                    params, dec["token"], dec["cache"], wl.seq_len - 1)
            model_flops = 2.0 * n_active * wl.global_batch
        # the parameters, held global here, as one rank would hold them
        args_zone += tree_bytes(params)
        args_rank += rank_bytes(params, pspecs, mesh)
    trace_s = time.perf_counter() - t0
    bad = [t.device for t in utils.tree_leaves(out)
           if isinstance(t, torch.Tensor) and not t.is_meta]
    if bad:
        raise RuntimeError(f"the traced step left meta: outputs on {bad}")
    del out
    counts = mode.record()
    rec.update(_analyze(counts, n_dev, model_flops))
    rec["memory"] = {"argument_bytes": args_zone,
                     "step_peak_bytes": counts["peak_bytes"],
                     "peak_bytes": args_zone + counts["peak_bytes"],
                     "argument_bytes_per_rank": args_rank}
    rec.update({"status": "ok", "n_devices": n_dev, "n_params": n_params,
                "n_active_params": n_active, "trace_s": round(trace_s, 2)})
    if verbose:
        r = rec["roofline"]
        print(f"[{arch} x {wl_name} x {mesh_name}] OK trace={trace_s:.1f}s "
              f"peak={rec['memory']['peak_bytes'] / 2**30:.2f}GiB "
              f"rank={args_rank / 2**30:.2f}GiB "
              f"compute={r['compute_s'] * 1e3:.2f}ms "
              f"memory={r['memory_s'] * 1e3:.2f}ms "
              f"coll={r['collective_s'] * 1e3:.2f}ms bound={r['bound']}",
              flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--workload", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--protect", default="mlpc")
    ap.add_argument("--out", default="dryrun_results_torch.json")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already in --out")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    wls = list(WORKLOADS) if args.workload == "all" else [args.workload]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    done = set()
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
        done = {(r["arch"], r["workload"], r["mesh"]) for r in results
                if r.get("status") in ("ok", "skip")}
        results = [r for r in results
                   if (r["arch"], r["workload"], r["mesh"]) in done]

    failures = 0
    for arch in archs:
        for wl in wls:
            for mp in meshes:
                key = (arch, wl, "2x16x16" if mp else "16x16")
                if key in done:
                    continue
                try:
                    rec = dryrun_cell(arch, wl, mp, protect=args.protect)
                except Exception as e:  # noqa: BLE001 — record and continue
                    rec = {"arch": arch, "workload": wl,
                           "mesh": key[2], "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    failures += 1
                    print(f"[{arch} x {wl} x {key[2]}] FAILED: "
                          f"{rec['error']}", flush=True)
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r.get("status") == "ok")
    n_skip = sum(1 for r in results if r.get("status") == "skip")
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skip, "
          f"{failures} failed -> {args.out}")
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())

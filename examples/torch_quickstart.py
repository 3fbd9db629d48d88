"""Quickstart: protect any zone-placed PyTorch state with the port's Pool.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]

The whole public surface is the `Pool` facade — the analogue of
Pangolin's three-call API (paper Listing 2):

    pgl_open            ->  Pool.open(state, specs, mesh=..., config=...)
    pgl_tx_begin/commit ->  with pool.transaction() as tx: tx.stage(new)
    pgl_tx_abort        ->  canary mismatch inside the context
    async commit (FliT) ->  pool.commit_async(new) -> CommitTicket;
                            pool.drain() at any boundary
    SIGBUS handler      ->  pool.recover(Fault.rank_loss(r))
    scrubbing thread    ->  pool.scrub() / pool.maybe_scrub()

`ProtectConfig` is the single knob: mode ladder (none < ml < mlp < mlpc,
plus replica), the Reed-Solomon syndrome stack height (redundancy r in
1..4 — any e <= r simultaneous rank losses reconstruct), the deferred
window W, and the scrub cadence.  This demo: build a pool over a pytree
placed on a (4, 2) zone mesh, commit a transactional update, lose a rank,
recover it online, scribble a page, scrub-detect + repair it, and abort a
transaction whose staging buffer smashed its canary.  The mesh is a
`ZoneMesh`: one device holds every rank of the zone, so the demo runs on
one GPU (the default) or, with `--device cpu`, on the CPU.
"""
import argparse

import torch

from repro_torch import Fault, P, Pool, ProtectConfig, ZoneMesh, utils
from repro_torch.obs import prometheus_text
from repro_torch.runtime import failure
from repro_torch.tenancy import GOLD, PoolGroup


def make_state(k, device):
    """A state pytree: FSDP weights, TP weights, a replicated scalar."""
    return {
        "w_fsdp": torch.arange(16 * 64, dtype=torch.float32,
                               device=device).reshape(16, 64) * (.01 * k),
        "w_tp": torch.ones(8, 32, dtype=torch.bfloat16, device=device) * k,
        "scale": torch.tensor(float(k), device=device),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = utils.resolve_device(args.device)

    # 1. a state pytree on a (4, 2) zone mesh, one spec a leaf
    mesh = ZoneMesh((4, 2), ("data", "model"))
    specs = {"w_fsdp": P("data", "model"), "w_tp": P(None, "model"),
             "scale": P()}
    state = make_state(1, device)

    # 2. pgl_open: checksums detect corruption, XOR parity across the 4-rank
    #    zone repairs it, at 1/4 storage overhead (1/G; 1% at G=100)
    pool = Pool.open(state, specs, mesh=mesh,
                     config=ProtectConfig(mode="mlpc", block_words=64),
                     device=device)
    print("protected:", pool.overhead_report())

    # 3. transactional update (open -> mutate the micro-buffer -> commit)
    new_state = utils.tree_map(lambda x: (x * 2).to(x.dtype), state)
    with pool.transaction(rng_key=utils.prng_key(0)) as tx:
        tx.stage(new_state)
    print(f"commit ok={tx.ok} step={pool.step}")

    # 4. media error: lose data-rank 2 entirely; rebuild online from parity
    want = pool.state["w_fsdp"].clone()
    pool.prot, event = failure.inject_rank_loss(pool.protector, pool.prot,
                                                rank=2)
    rep = pool.recover(Fault.rank_loss(event.lost_rank))
    assert rep.verified
    assert torch.equal(pool.state["w_fsdp"], want)
    print("rank-loss recovery: bit-exact")

    # 5. silent scribble: flip bits, detect by scrub, repair the page
    pool.prot, event = failure.inject_scribble(pool.protector, pool.prot,
                                               rank=1, word_offsets=[7])
    report = pool.scrub()
    print("scrub found corrupted (rank, page):", report.bad_locations)
    assert report.repaired and report.repair_ok
    assert torch.equal(pool.state["w_fsdp"], want)
    print("scribble repair: bit-exact")

    # 6. canary: a staged buffer overrun aborts the commit, state untouched
    step_before = pool.step
    with pool.transaction() as tx:
        tx.watch(failure.smashed_canary_buffer(4096, device))
        tx.stage(utils.tree_map(torch.zeros_like, new_state))
    assert tx.aborted and not tx.ok and pool.step == step_before
    assert torch.equal(pool.state["w_fsdp"], want)
    print("canary abort: state untouched")

    # 7. telemetry: every pool publishes into a host-side metrics registry
    #    and folds its degradation signals into a HealthReport.  The same
    #    surface backs the --metrics-dir / --trace-dir launch flags
    #    (repro_torch.launch.train / .serve) and a Prometheus scrape.
    stats = pool.stats()                # host-only snapshot, no device sync
    print(f"stats: commits={stats['commits']} recoveries="
          f"{stats['recoveries']} scrub_coverage="
          f"{stats['scrub']['full_fraction']:.2f}")
    health = pool.health()              # green | degraded | critical
    print(f"health: {health.status} {health.reasons}")
    assert health.status == "degraded"  # the repairing scrub left
    assert health.suspect               # failure suspicion outstanding
    pool.scrub()                        # ...which a clean scrub heals
    print(f"health after clean scrub: {pool.health().status}")
    assert pool.health().status == "green"
    assert stats["recoveries"] == 1 and stats["aborted_commits"] == 1
    assert "pool_commits_total" in prometheus_text(pool.metrics)
    print("telemetry surface live")

    # 8. multi-tenant: a PoolGroup hosts many pools at once.  Same-shape
    #    same-config tenants share one cohort — one Protector — and a
    #    commit wave lands them in ONE batched dispatch, bit-identical to N
    #    separate pool.commit calls; a shared scrub scheduler spreads
    #    verification over tenants under a page budget, and QoS presets
    #    (GOLD/SILVER/BRONZE) pick protection + scrub weight.
    grp = PoolGroup(mesh, device=device)
    for k, tid in enumerate(("alice", "bob"), start=1):
        grp.admit(tid, make_state(k, device), specs, qos=GOLD)
    updates = {tid: make_state(k + 10, device)
               for k, tid in enumerate(("alice", "bob"), start=1)}
    verdicts = grp.commit(updates)      # ONE batched dispatch
    assert all(bool(v) for v in verdicts.values())
    grp.scrub_tick()                    # shared-scheduler scrub pass
    assert grp.health()["status"] == "green"
    assert torch.equal(grp["alice"].pool.state["w_fsdp"],
                       updates["alice"]["w_fsdp"])
    print(f"pool group: {len(grp)} tenants, 1 cohort, batched commit ok")

    # 9. async commit pipeline: `commit_async` returns a CommitTicket — a
    #    future over the commit's device verdict — and up to
    #    `ProtectConfig.pipeline_depth` commits stay in flight at once, so
    #    the host dispatches commit t+k while the device still runs commit
    #    t.  `drain()` at any boundary lands the pipeline bit-identical to
    #    synchronous commits (flush / scrub / recover all drain first).
    apool = Pool.open(make_state(5, device), specs, mesh=mesh,
                      config=ProtectConfig(mode="mlpc", block_words=64,
                                           pipeline_depth=4),
                      device=device)
    tickets = []
    cur = make_state(5, device)
    for i in range(4):
        cur = utils.tree_map(lambda x: (x * 1.01).to(x.dtype), cur)
        tickets.append(apool.commit_async(cur, data_cursor=i))
    print(f"async: {apool.in_flight} commits in flight")
    apool.drain()
    assert all(t.result() for t in tickets)      # every verdict landed
    lat = apool.stats()["commit_resolve_ms"]
    print(f"async: drained, resolve p99={lat['p99']:.2f} ms "
          f"(span id of last dispatch: {tickets[-1].span_id})")
    print("all quickstart checks passed")


if __name__ == "__main__":
    main()

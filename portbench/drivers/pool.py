"""Transactions on one protected pool, as a closed loop of one client.

The zone's state is made on the device from the seed: every leaf random
normal (`base`), in its own dtype.  Transaction k writes `base + c(k)`
into the words it touches, with `c(k)` a step of 2^-8 drawn from the seed
and k, exact in every dtype, so the state after any sequence of
transactions has a closed form that the reference recomputes on its own.
Transaction 0 is the state the pool opens with.

The mix file chooses the transaction:

  * `"kind": "bulk"` rewrites every word of every leaf and commits it with
    `Pool.commit` (one verdict read a commit);
  * `"kind": "patch"` rewrites `pages` distinct page columns of every
    rank's row, drawn by a scrambled Zipf(`zipf_theta`) over the page
    columns of the data leaf, and commits them with
    `Pool.commit_async(..., dirty_pages=)` at the ring depth the mix sets;
  * `"fault_every": n` injects, after every n-th commit, the next fault of
    `faults` in turn (ranks and pages drawn from the seed) and recovers it
    with `Pool.recover(..., reverify=True)` before the next commit.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
OFFSET_STEPS = 4093          # c(k) = (1 + (k * A + salt) mod 4093) / 256
OFFSET_MUL = 2654435761
SAMPLED_RECOVERIES = 64      # recovered rank rows kept for the check
CHUNK = 512                  # patch transactions drawn at a time


def offset(seed: int, k: int) -> float:
    salt = seed % OFFSET_STEPS
    return float(1 + (k * OFFSET_MUL + salt) % OFFSET_STEPS) / 256.0


def make_base(cfg: dict, seed: int, device) -> dict:
    """Every leaf of the configuration, random normal from the seed, made
    on the device in one draw a leaf."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 63) - 1))
    out = {}
    for key in sorted(cfg["leaves"]):
        leaf = cfg["leaves"][key]
        x = torch.randn(leaf["shape"], generator=gen, device=device)
        out[key] = x.to(DTYPES[leaf["dtype"]])
    return out


def mesh_sizes(cfg: dict) -> dict:
    return {"data": cfg["ranks"], "model": cfg["model"]}


def specs_of(cfg: dict) -> dict:
    return {k: v["spec"] for k, v in cfg["leaves"].items()}


def data_leaf(cfg: dict) -> str:
    (key,) = [k for k, v in cfg["leaves"].items() if "data" in v["spec"]]
    return key


def local_shape(cfg: dict, key: str) -> list:
    """A leaf's shape on one rank."""
    leaf, sizes = cfg["leaves"][key], mesh_sizes(cfg)
    return [s // (sizes[a] if a else 1) for s, a in zip(
        leaf["shape"], list(leaf["spec"]) + [None] * len(leaf["shape"]))]


def leaf_slots(cfg: dict) -> dict:
    """key -> (first word, words) of each leaf in a rank's row: leaves in
    sorted key order, each a whole number of words."""
    out, offset_w = {}, 0
    for key in sorted(cfg["leaves"]):
        leaf = cfg["leaves"][key]
        n = int(np.prod(local_shape(cfg, key), dtype=np.int64))
        words = -(-(n * (2 if leaf["dtype"] == "bfloat16" else 4)) // 4)
        out[key] = (offset_w, words)
        offset_w += words
    return out


def patch_columns(cfg: dict) -> np.ndarray:
    """The page columns a patch may touch: every page holding a word of the
    data leaf (which must be 32-bit)."""
    first, n = leaf_slots(cfg)[data_leaf(cfg)]
    bw = cfg["block_words"]
    return np.arange(first // bw, (first + n - 1) // bw + 1)


class PatchSets:
    """Transaction k's page columns: `pages` distinct ones, drawn by a
    Zipf(theta) over the columns' ranks (successive sampling: draws with
    replacement, each column kept at its first draw, until `pages` are
    kept, as a weighted draw without replacement does), the ranks mapped to
    columns by a permutation from the seed (YCSB's scrambled Zipfian)."""

    def __init__(self, cfg: dict, mix: dict, seed: int):
        self.columns = patch_columns(cfg)
        n = len(self.columns)
        w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** mix["zipf_theta"]
        self.cdf = np.cumsum(w / w.sum())
        self.perm = np.random.default_rng((seed, 1)).permutation(n)
        self.seed, self.pages = seed, mix["pages"]
        if self.pages > n:
            raise ValueError(f"{self.pages} distinct pages of {n}")

    def __call__(self, k: int) -> list:
        rng = np.random.default_rng((self.seed, 2, k))
        kept = np.empty(0, np.int64)
        while kept.size < self.pages:
            draws = np.minimum(np.searchsorted(
                self.cdf, rng.random(8 * self.pages)), len(self.cdf) - 1)
            both = np.concatenate([kept, draws])
            _, first = np.unique(both, return_index=True)
            kept = both[np.sort(first)]
        return sorted(int(c) for c in self.columns[self.perm[
            kept[:self.pages]]])


def page_words(cfg: dict, cols: torch.Tensor,
               lanes: torch.Tensor) -> torch.Tensor:
    """The data leaf's local words (in each rank's shard) that lie in the
    page columns `cols` (a device tensor; `lanes`: arange(block_words));
    the words of an edge page outside the leaf are clamped onto its first
    or last word, which are in the page too."""
    first, n = leaf_slots(cfg)[data_leaf(cfg)]
    words = cols[:, None] * cfg["block_words"] + lanes
    return words.clamp_(first, first + n - 1).sub_(first).flatten()


def _garble(protector, prot, fault):
    """The rows a fault named undone again (the planted fault of a
    recovery that repairs nothing)."""
    from repro_torch.runtime import failure
    ranks = (list(fault.ranks) if fault.kind == "multi_loss"
             else [fault.rank] if fault.kind == "rank_loss"
             else [fault.locations[0][0]])
    if len(ranks) == 1:
        return failure.inject_rank_loss(protector, prot, ranks[0])
    return failure.inject_multi_rank_loss(protector, prot, ranks)


class Cell:
    def __init__(self, cfg: dict, mix: dict, device, seed: int, spans):
        self.cfg, self.mix, self.dev, self.seed = cfg, mix, device, seed
        self.spans = spans
        self.k = 0
        self.patch = mix["kind"] == "patch"
        self.fault_every = mix.get("fault_every", 0)
        self.recovered = []          # (k, ranks, {key: rank slices})
        self.planted = None

    def plant(self, fault: str) -> None:
        """Break the timed path underneath (for the tests of the check):
        "unchanged" - a commit that keeps the old state and says clean;
        "altered" - one word of the syndrome stack flipped after each
        commit; "no_repair" - a recovery that rebuilds nothing;
        "stale_stack" - the control, put in the check's place."""
        if fault not in ("unchanged", "altered", "no_repair", "stale_stack"):
            raise ValueError(f"no planted fault {fault!r}")
        self.planted = fault

    def _break(self) -> None:
        pool, fault = self.pool, self.planted
        if fault == "unchanged":
            done = torch.ones((), dtype=torch.bool, device=self.dev)
            pool.commit = lambda new, **kw: done
            ring = pool.commit_async

            def keep(new, **kw):
                return ring(pool.state, **kw)
            pool.commit_async = keep
        elif fault == "altered":
            flips = iter(range(1 << 30))
            for name in ("commit", "commit_async"):
                orig = getattr(pool, name)

                def flipped(new, _orig=orig, **kw):
                    out = _orig(new, **kw)
                    synd = pool.prot.synd
                    word = next(flips) % synd.shape[-1]
                    synd[(0,) * (synd.dim() - 1) + (word,)] ^= 1
                    return out
                setattr(pool, name, flipped)
        elif fault == "no_repair":
            rep = pool.recover

            def nothing(fault, **kw):
                out = rep(fault, **kw)
                pool.inject(lambda protector, prot: _garble(
                    protector, prot, fault))
                return out
            pool.recover = nothing

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch import P, Pool, ProtectConfig, ZoneMesh
        from repro_torch.kernels import _build
        if self.dev.type == "cuda":
            _build.build()
        cfg = self.cfg
        self.base = make_base(cfg, self.seed, self.dev)
        self.data = data_leaf(cfg)
        specs = {k: P(*v) for k, v in specs_of(cfg).items()}
        mesh = ZoneMesh((cfg["ranks"], cfg["model"]), ("data", "model"))
        prot = dict(cfg["protect"])
        prot.update(self.mix.get("protect", {}))
        self.cur = self.state_at(0)
        self.pool = Pool.open(self.cur, specs, mesh=mesh, device=self.dev,
                              config=ProtectConfig(**prot))
        if self.patch:
            self.sets = PatchSets(cfg, self.mix, self.seed)
            self.lanes = torch.arange(cfg["block_words"], device=self.dev)
            self.chunk = None
            self.page_sets = {}         # transaction -> its page columns
        self.rng = np.random.default_rng((self.seed, 3))
        self.faults = self.mix.get("faults", [])
        self.stats = self.fresh_stats()
        # warm-up: every shape the window uses (a fault of each kind too)
        n_warm = max(self.mix.get("warmup", 4),
                     self.fault_every * len(self.faults))
        for _ in range(n_warm):
            self.transaction()
        self.drain()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        self.stats = self.fresh_stats()
        if self.planted is not None:
            self._break()

    @staticmethod
    def fresh_stats() -> dict:
        return {"latency_ms": [], "tickets": [], "clean": 0, "commits": 0,
                "api_s": 0.0, "recoveries": 0, "recoveries_failed": 0}

    def state_at(self, k: int) -> dict:
        c = offset(self.seed, k)
        return {key: v + c for key, v in self.base.items()}

    # -- one transaction ------------------------------------------------------

    def transaction(self) -> None:
        self.k += 1
        k = self.k
        if self.patch:
            with self.spans("traffic"):
                pages, cols = self.patch_pages(k)
                idx = page_words(self.cfg, cols, self.lanes)
                new = dict(self.cur)
                w = self.cur[self.data].clone()
                ranks = self.cfg["ranks"]
                flat, base = w.view(ranks, -1), self.base[self.data].view(
                    ranks, -1)
                flat[:, idx] = base[:, idx] + offset(self.seed, k)
                new[self.data] = w
            with self.spans("commit"):
                t0 = time.perf_counter()
                ticket = self.pool.commit_async(new, dirty_pages=pages)
                for t in self.pool.poll():
                    self._resolved(t)
                self.stats["api_s"] += time.perf_counter() - t0
            self.stats["tickets"].append(ticket)
            self.page_sets[k] = np.asarray(pages, np.int32)
        else:
            with self.spans("traffic"):
                new = self.state_at(k)
            with self.spans("commit"):
                t0 = time.perf_counter()
                ok = self.pool.commit(new)
                clean = bool(ok)
                dt = time.perf_counter() - t0
            self.stats["api_s"] += dt
            self.stats["latency_ms"].append(dt * 1e3)
            self.stats["commits"] += 1
            self.stats["clean"] += int(clean)
        self.cur = new
        if self.fault_every and k % self.fault_every == 0:
            self.fault(k)

    def patch_pages(self, k: int) -> tuple:
        """Transaction k's page columns, on the host and on the device.
        They are drawn CHUNK transactions at a time and copied to the card
        in one piece: a copy from pageable host memory waits for the
        stream, which would drain the ring every transaction."""
        if not self.chunk or k - self.chunk[0] >= len(self.chunk[1]):
            host = np.stack([np.asarray(self.sets(j), np.int64)
                             for j in range(k, k + CHUNK)])
            self.chunk = (k, host, torch.as_tensor(host).to(self.dev))
        i = k - self.chunk[0]
        return self.chunk[1][i].tolist(), self.chunk[2][i]

    def _resolved(self, ticket) -> None:
        self.stats["commits"] += 1
        self.stats["clean"] += int(bool(ticket.result()))

    def drain(self) -> None:
        if self.patch:
            with self.spans("drain"):
                t0 = time.perf_counter()
                for t in self.pool.drain():
                    self._resolved(t)
                self.stats["api_s"] += time.perf_counter() - t0

    # -- faults ---------------------------------------------------------------

    def fault(self, k: int) -> None:
        from repro_torch import Fault
        from repro_torch.runtime import failure
        spec = self.faults[(k // self.fault_every - 1) % len(self.faults)]
        ranks_n = self.cfg["ranks"]
        kind = spec["kind"]
        with self.spans("inject"):
            if kind == "scribble":
                rank = int(self.rng.integers(ranks_n))
                cols = patch_columns(self.cfg)
                pages = sorted(int(p) for p in self.rng.choice(
                    cols, size=spec["pages"], replace=False))
                bw = self.cfg["block_words"]
                words = [p * bw + int(self.rng.integers(bw)) for p in pages]
                fn = functools.partial(failure.inject_scribble, rank=rank,
                                       word_offsets=words,
                                       xor_mask=int(self.rng.integers(
                                           1, 1 << 32)))
                ranks = [rank]
            else:
                ranks = sorted(int(r) for r in self.rng.choice(
                    ranks_n, size=spec["ranks"], replace=False))
                fn = (functools.partial(failure.inject_rank_loss,
                                        rank=ranks[0])
                      if kind == "rank_loss" else
                      functools.partial(failure.inject_multi_rank_loss,
                                        ranks=ranks))
            event = self.pool.inject(fn)
        with self.spans("recover"):
            rep = self.pool.recover(Fault.from_event(event), reverify=True)
        self.stats["recoveries"] += 1
        self.stats["recoveries_failed"] += int(
            not (rep.verified and rep.reverified))
        if len(self.recovered) < SAMPLED_RECOVERIES:
            with self.spans("sample"):
                zone = self.pool.prot.state
                self.recovered.append((k, ranks, {
                    key: torch.stack([zone[key][r].clone() for r in ranks])
                    for key in zone}))

    # -- the window -----------------------------------------------------------

    def histogram(self, name: str):
        h = self.pool.metrics.histogram(name)
        return h.sum, h.count

    def mark(self) -> dict:
        """The clock and every count the window's record is taken from."""
        st = self.stats
        hist = {n: self.histogram(n) for n in (
            "pool_commit_dispatch_ms", "pool_recovery_total_ms")}
        return {"t": time.perf_counter(), "hist": hist,
                "n_latency": len(st["latency_ms"]),
                "n_tickets": len(st["tickets"]),
                **{k: st[k] for k in ("commits", "clean", "api_s",
                                      "recoveries", "recoveries_failed")}}

    def window(self, seconds: float, tick=None) -> dict:
        """The closed loop for `seconds`.  In a traced run `tick()` comes
        after each transaction, and the record's clocks and counts are
        those after the call that stopped the trace (none if it never
        did); `attempted` and `failed` are always the whole window's."""
        start = self.mark()
        since = start if tick is None else None
        while time.perf_counter() - start["t"] < seconds:
            self.transaction()
            if tick is not None and tick():
                since = self.mark()
        self.drain()
        end = self.mark()
        since = since or end
        d = lambda k, a=since: end[k] - a[k]
        hist = {n: (end["hist"][n][0] - since["hist"][n][0],
                    end["hist"][n][1] - since["hist"][n][1])
                for n in end["hist"]}
        st = self.stats
        return {"window_s": d("t"), "commits": d("commits"),
                "clean": d("clean"),
                "latency_ms": st["latency_ms"][since["n_latency"]:],
                "ticket_ms": [t.resolve_latency_ms
                              for t in st["tickets"][since["n_tickets"]:]],
                "api_s": d("api_s"),
                "dispatch_ms": hist["pool_commit_dispatch_ms"],
                "recover_ms": hist["pool_recovery_total_ms"],
                "attempted": d("commits", start) + d("recoveries", start),
                "failed": (d("commits", start) - d("clean", start)
                           + d("recoveries_failed", start))}

    # -- the check ------------------------------------------------------------

    def expected_state(self, upto: int = None) -> dict:
        """The state the pool must hold after transaction `upto` (the last
        by default)."""
        upto = self.k if upto is None else upto
        if not self.patch:
            return self.state_at(upto)
        cfg, ranks = self.cfg, self.cfg["ranks"]
        first, n = leaf_slots(cfg)[self.data]
        bw = cfg["block_words"]
        local = self.base[self.data].numel() // ranks
        page = (np.arange(local) + first) // bw
        last = np.zeros(int(page.max()) + 1, np.int64)
        for k in sorted(self.page_sets):
            if k <= upto:
                last[self.page_sets[k]] = k
        offsets = np.array([offset(self.seed, k) for k in range(upto + 1)],
                           np.float32)
        per_word = torch.as_tensor(offsets[last[page]], device=self.dev)
        out = {key: v + offset(self.seed, 0) for key, v in self.base.items()
               if key != self.data}
        base = self.base[self.data]
        out[self.data] = (base.view(ranks, -1) + per_word).view(base.shape)
        return out

    def outputs(self) -> dict:
        """What the program holds, read for the check."""
        prot = self.pool.prot
        return {"state": self.pool.state, "row": prot.row,
                "synd": prot.synd, "cksums": prot.cksums,
                "digest": prot.digest}

    def check(self, fault: str = None) -> dict:
        """Every number compared, each with its limit (all exact)."""
        from portbench.reference import zone as ref
        report = self.pool.scrub()
        scrub_flags = int(bool(report.suspect)) + sum(
            1 for v in (report.synd_ok or []) if not v)
        got = self.outputs()
        exp = self.expected_state()
        cfg, specs, sizes = self.cfg, specs_of(self.cfg), mesh_sizes(self.cfg)
        z = ref.Zone(exp, specs, sizes=sizes, bw=cfg["block_words"],
                     r=cfg["protect"]["redundancy"], device=self.dev)
        if fault == "stale_stack":
            got["synd"] = self.control_stack(z, got["synd"])
        off = {"state_words_off": sum(
            int((ref.words_of(got["state"][k]) != ref.words_of(exp[k])).sum())
            for k in exp)}
        off.update(ref.compare(z, got))
        recovered_off = 0
        for k, rks, slices in self.recovered:
            want = self.state_at(k)
            for key, got_slices in slices.items():
                for j, r in enumerate(rks):
                    w = ref.rank_shard(want[key], specs[key], z.coords(r, 0),
                                       sizes)
                    recovered_off += int((ref.words_of(got_slices[j]) !=
                                          ref.words_of(w)).sum())
        off["recovered_words_off"] = recovered_off
        off["scrub_flags"] = scrub_flags
        return {k: (v, 0) for k, v in off.items()}

    def control_stack(self, z, like: torch.Tensor) -> torch.Tensor:
        """The control: the reference's stack one transaction behind (a
        refresh deferred past the commit that acknowledged it), laid out
        as the program's, to be compared in its place."""
        from portbench.reference import zone as ref
        zp = ref.Zone(self.expected_state(self.k - 1), z.specs,
                      sizes=z.sizes, bw=z.bw, r=z.r, device=z.device)
        out = torch.empty_like(like)
        for col in range(zp.columns()):
            planes = zp.planes(col)
            for i in range(zp.ranks):
                out[zp.index(i, col)] = zp.segment(planes, i)
        return out

    def free(self) -> None:
        del self.pool
        self.cur = None

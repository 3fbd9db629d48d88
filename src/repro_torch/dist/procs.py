"""The multi-process zone backend: the process group of a split zone and
the exchanges between its processes.

A zone split over W processes (`ZoneMesh(..., group=)`, dist/sharding.py)
runs one worker process a block of G / W data ranks, each on its own
device — on one card, W processes, each with its own CUDA context.  Every
zone collective folds over the process's own ranks first and then makes
one exchange between the processes.  The exchanges are staged through
host buffers over a gloo group: the device tensor is copied to the host,
exchanged, and the result copied back to the device.  XOR is associative
and commutative, so a split fold is bit-equal to the one-process fold.

    group = init_zone_group(rank, world, store_path)
    mesh = ZoneMesh((G, 1), ("data", "model"), group=group)

`spawn_zone(fn, world, *args)` runs `fn(group, *args)` in `world` spawned
processes (CUDA forbids `fork` once a context exists) and returns their
results in rank order; it raises if a worker raised, exited without a
result or outlived its timeout.

`ZoneGroup.stats` counts what the exchanges cost this process: the bytes
staged between device and host (both ways), the bytes it sent to other
processes (`(W-1)/W` of an all-to-all's buffer, `W-1` copies of an
all-gather's block; `moved_bytes`: those a rescale's point-to-point
moves sent), the wall ms from the staging copy to the result back on the
device, and of those the ms of the two copies (`copy_ms`; the rest is
gloo's).  A subgroup counts into its world's.  The sent bytes also go
to the active cost counter (kernels/cost.py) as the kind
`process-exchange`.

A split zone runs the synchronous engine behind `Pool`, the deferred
engine (window > 1, bulk and patch) and the async commit ring
(pipeline_depth > 1, staged canaries), and every host of a pool on it:
`PoolGroup`, `runtime.Server` (data-parallel decode, each process its
block's rows of the batch), `runtime.Trainer` (each process its
microbatches, the gradients folded in microbatch order) and the chaos
campaign (repro_torch/chaos).  Each reads and writes its process's block
(`ZoneMesh.block_mesh`) and makes only the exchanges its engine makes.

A zone group may be a subgroup of the spawned world: `group.sub(members)`
(collective over the world: every process calls it, with the same
members in the same order; each subgroup is made once and cached) gives
the members their `ZoneGroup` and every other process None.  A mesh over
a subgroup (`sharding.split_mesh`) holds no block on a process outside
it, a *spare* (`Spare`, `ZoneMesh.is_spare`): reading its rank or making
an exchange there raises.  `Pool.rescale` / `elastic.reshard_state`
move a pool between two meshes of one world — the same group, or two
subgroups of it, which changes the process count (`Pool.join` on a
process that was a spare); `PoolGroup.rescale` / `PoolGroup.join` move a
group of tenants so; the rows that change owner go point to point
(`send_recv`), and so do a chaos snapshot restored onto another mesh and
a golden run's final blocks.  What stays refused: a move between meshes
with no common parent group (a one-process zone and a split one,
`refuse_regroup`), a W that does not divide G (`ZoneMesh`), a split
server whose batch G does not divide, a split
trainer whose microbatches W does not divide (runtime/), and an NCCL
group (NCCL, one card a process, is slice S7d): only gloo groups are
zone groups.

Large exchanges go in pieces of at most `CHUNK_BYTES` a process
(`in_pieces`), so the pageable host buffers that
stage them stay small.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import multiprocessing.connection
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.kernels import cost as kcost

GROUP_TIMEOUT_S = 120.0        # a collective that waits longer raises
CHUNK_BYTES = 1 << 28          # a large exchange's piece, a process


class ZoneGroup:
    """A gloo process group as the exchange layer of a split zone: `world`
    processes, this one `rank`, and the exchanges on device tensors.  A
    subgroup (`sub`) knows its `parent` and its `members` (their ranks in
    the parent, in its own rank order) and counts into the parent's
    `stats`: they are what this process's exchanges cost."""

    def __init__(self, pg=None, *, timeout: float = GROUP_TIMEOUT_S,
                 parent: Optional["ZoneGroup"] = None, members=None):
        pg = dist.group.WORLD if pg is None else pg
        backend = dist.get_backend(pg)
        if backend != "gloo":
            raise ValueError(
                f"a {backend} process group cannot hold a split zone: the "
                "zone's exchanges are staged through host buffers over "
                "gloo (NCCL with one card a process is slice S7d)")
        self.pg = pg
        self.world = dist.get_world_size(pg)
        self.rank = dist.get_rank(pg)
        self.timeout = float(timeout)
        self.parent = parent
        self.members = (tuple(range(self.world)) if members is None
                        else tuple(members))
        self.stats = (parent.stats if parent is not None else
                      {"exchanges": 0, "staged_bytes": 0, "sent_bytes": 0,
                       "moved_bytes": 0, "ms": 0.0, "copy_ms": 0.0})
        self._subs: dict = {}

    def __repr__(self) -> str:
        sub = "" if self.parent is None else f", members={self.members}"
        return f"ZoneGroup(rank={self.rank}, world={self.world}{sub})"

    @property
    def root(self) -> "ZoneGroup":
        """The group every subgroup is made from (itself, for the world)."""
        return self if self.parent is None else self.parent

    def sub(self, members) -> Optional["ZoneGroup"]:
        """The subgroup of `members` (ranks of this group, the world's):
        its `ZoneGroup` on a member, None on any other process.  A
        collective over the world: every process calls it with the same
        members, subgroups in the same order (`torch.distributed.new_group`
        is); each is made once and cached by its members.  All the ranks
        give this group itself."""
        if self.parent is not None:
            raise ValueError("subgroups are made from the world's group, "
                             f"not from a subgroup {self!r}")
        members = tuple(sorted({int(m) for m in members}))
        if not members or members[0] < 0 or members[-1] >= self.world:
            raise ValueError(f"members {members} are not ranks of a group "
                             f"of {self.world}")
        if members == self.members:
            return self
        if members not in self._subs:
            pg = dist.new_group(
                [dist.get_global_rank(self.pg, m) for m in members],
                timeout=datetime.timedelta(seconds=self.timeout),
                backend="gloo")
            self._subs[members] = (
                ZoneGroup(pg, timeout=self.timeout, parent=self,
                          members=members)
                if self.rank in members else None)
        return self._subs[members]

    def broadcast_host(self, value, src: int):
        """A host value held by process `src` on every process: an int
        such as a step counter, or any picklable value such as a group's
        tenant table (the others pass None; not counted, like
        `barrier`)."""
        box = [value]
        dist.broadcast_object_list(
            box, src=dist.get_global_rank(self.pg, src), group=self.pg)
        return box[0]

    def send_recv(self, sends: dict, recvs: dict, device) -> dict:
        """Point-to-point exchanges of byte buffers over this group: `sends`
        {rank: 1-D uint8 device tensor} goes to each rank, `recvs` {rank:
        nbytes} comes from each; returns {rank: 1-D uint8 tensor on
        `device`}.  Only the processes named take part (no collective);
        each pair's buffer goes in pieces of at most `CHUNK_BYTES`, a round
        a piece, so the host buffers that stage it stay small; the pairs'
        walk is the same on every process, so no pair waits on one that
        waits on it.  Counted as one exchange."""
        if any(t.is_cuda for t in sends.values()):
            torch.cuda.current_stream(device).synchronize()
        t0 = time.perf_counter()
        copy_s = 0.0
        step = CHUNK_BYTES
        sizes = [t.numel() for t in sends.values()] + list(recvs.values())
        rounds = max([-(-n // step) for n in sizes] + [0])
        got = {r: torch.empty(int(n), dtype=torch.uint8)
               for r, n in recvs.items()}
        glob = {r: dist.get_global_rank(self.pg, r)
                for r in (*sends, *recvs)}
        for i in range(rounds):
            lo, hi = i * step, (i + 1) * step
            works, held = [], []   # a staged piece lives to its wait
            for r in sorted(recvs):
                if lo < recvs[r]:
                    works.append(dist.irecv(got[r][lo:hi], src=glob[r],
                                            group=self.pg))
            for r in sorted(sends):
                piece = sends[r][lo:hi]
                if piece.numel():
                    c0 = time.perf_counter()
                    host = piece.to("cpu", copy=True)
                    copy_s += time.perf_counter() - c0
                    held.append(host)
                    works.append(dist.isend(host, dst=glob[r],
                                            group=self.pg))
            for w in works:
                w.wait(datetime.timedelta(seconds=self.timeout))
        c0 = time.perf_counter()
        out = {r: t.to(device) for r, t in got.items()}
        if torch.device(device).type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        t1 = time.perf_counter()
        sent = sum(t.numel() for t in sends.values())
        st = self.stats
        st["exchanges"] += 1
        st["staged_bytes"] += sent + sum(int(n) for n in recvs.values())
        st["sent_bytes"] += sent
        st["moved_bytes"] += sent
        st["ms"] += (t1 - t0) * 1e3
        st["copy_ms"] += (copy_s + t1 - c0) * 1e3
        kcost.wire(kcost.EXCHANGE, sent)
        return out

    def _exchange(self, x: torch.Tensor, run, sent_bytes: int):
        """Stage `x` to the host, `run(host) -> host result`, and copy the
        result back to x's device; counts the exchange.  A bool tensor
        travels as uint8."""
        if x.is_cuda:
            # the device's earlier work is not the exchange's time
            torch.cuda.current_stream(x.device).synchronize()
        t0 = time.perf_counter()
        host = x.detach().to("cpu", copy=True)
        t1 = time.perf_counter()
        if host.dtype == torch.bool:
            out = run(host.to(torch.uint8)).to(torch.bool)
        else:
            out = run(host.contiguous())
        t2 = time.perf_counter()
        out = out.to(x.device)
        if x.is_cuda:
            torch.cuda.current_stream(x.device).synchronize()
        t3 = time.perf_counter()
        st = self.stats
        st["exchanges"] += 1
        st["staged_bytes"] += (x.numel() * x.element_size()
                               + out.numel() * out.element_size())
        st["sent_bytes"] += sent_bytes
        st["ms"] += (t3 - t0) * 1e3
        st["copy_ms"] += (t1 - t0 + t3 - t2) * 1e3
        kcost.wire(kcost.EXCHANGE, sent_bytes)
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """`(W, ...)` blocks, block q for process q -> `(W, ...)`, block q
        the one process q sent here."""
        if x.shape[0] != self.world:
            raise ValueError(f"all_to_all takes {self.world} blocks, got "
                             f"{x.shape[0]}")

        def run(h):
            out = torch.empty_like(h)
            dist.all_to_all_single(out, h, group=self.pg)
            return out
        nbytes = x.numel() * x.element_size()
        return self._exchange(x, run, nbytes * (self.world - 1)
                              // self.world)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """`x` from every process, stacked in rank order: `(W, *x.shape)`."""
        def run(h):
            parts = [torch.empty_like(h) for _ in range(self.world)]
            dist.all_gather(parts, h, group=self.pg)
            return torch.stack(parts)
        return self._exchange(x, run, x.numel() * x.element_size()
                              * (self.world - 1))

    def gather_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every process's `x` concatenated along `dim` in rank order (the
        zone-stacked tensor of the whole zone, from its blocks)."""
        return self.all_gather(x).movedim(0, dim).flatten(dim, dim + 1)

    def all_and(self, x: torch.Tensor) -> torch.Tensor:
        """The AND of a bool tensor across the processes (the reference's
        `pmin` of a verdict), on x's device."""
        return self.all_gather(x).all(dim=0)

    def agree(self, flag: bool) -> bool:
        """The AND of a host bool across the processes."""
        return bool(self.all_and(torch.tensor(bool(flag))))

    def barrier(self) -> None:
        """Wait for every process (no data; not counted): a timed span
        that starts after it starts on every process at once."""
        dist.barrier(group=self.pg)


def in_pieces(exchange, x: torch.Tensor) -> torch.Tensor:
    """`exchange(x)` (a `ZoneGroup`'s `all_to_all` of `(W, n)` blocks, or
    its `all_gather` of a 1-D `x`) in pieces of at most `CHUNK_BYTES` along
    x's last dim, so that each staging buffer stays small: the same result,
    the pieces concatenated along the result's last dim, more exchanges."""
    n = x.shape[-1]
    step = max(1, CHUNK_BYTES // x.element_size())
    if n <= step:
        return exchange(x)
    return torch.cat([exchange(x[..., i:i + step].contiguous())
                      for i in range(0, n, step)], dim=-1)


def init_zone_group(rank: int, world: int, store_path: str,
                    timeout: float = GROUP_TIMEOUT_S) -> ZoneGroup:
    """Join a `world`-process gloo group through a `file://` store at
    `store_path` (a file that does not exist yet, on a disk every process
    sees); a collective that waits past `timeout` seconds raises."""
    dist.init_process_group(
        "gloo", init_method=f"file://{store_path}", rank=int(rank),
        world_size=int(world),
        timeout=datetime.timedelta(seconds=float(timeout)))
    return ZoneGroup(dist.group.WORLD, timeout=timeout)


class SpareError(RuntimeError):
    """A spare process was asked for its block, its rank or an exchange."""


class Spare:
    """A subgroup of `parent` (its `members`, ranks of the parent) as a
    process outside it sees it: the group of a mesh on which this process
    is a spare.  It has the subgroup's `world` and `members` and no rank:
    reading `rank`, or any exchange, raises `SpareError`."""

    pg = None

    def __init__(self, parent: ZoneGroup, members):
        self.parent = parent
        self.members = tuple(members)
        self.world = len(self.members)

    @property
    def root(self) -> ZoneGroup:
        return self.parent

    def __repr__(self) -> str:
        return f"Spare(members={self.members}, of {self.parent!r})"

    def _refuse(self, what: str) -> SpareError:
        return SpareError(
            f"process {self.parent.rank} is a spare of a mesh over "
            f"processes {self.members}: it holds no block of that zone and "
            f"makes none of its exchanges ({what})")

    @property
    def rank(self) -> int:
        raise self._refuse("its rank")

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise self._refuse(name)


def root_of(group) -> Optional[ZoneGroup]:
    """The world's group a zone group (or a `Spare`) comes from; None for
    a zone on one process."""
    return None if group is None else group.root


def same_group(a, b) -> bool:
    """Two meshes' groups are one split (or both are one process)."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, Spare) or isinstance(b, Spare):
        return (isinstance(a, Spare) and isinstance(b, Spare)
                and a.parent is b.parent and a.members == b.members)
    return a.pg is b.pg


def refuse_regroup(old_mesh, new_mesh) -> None:
    """Raise when a move from `old_mesh` to `new_mesh` has no common
    parent group: a zone on one process and a split one, or splits of two
    worlds.  A move over one group, or between two subgroups of one world
    (the process count changes), is allowed; a W that does not divide G
    is refused by `ZoneMesh` itself."""
    a = getattr(old_mesh, "group", None)
    b = getattr(new_mesh, "group", None)
    if same_group(a, b):
        return
    ra, rb = root_of(a), root_of(b)
    if ra is None or rb is None or ra is not rb:
        wa = 1 if a is None else a.world
        wb = 1 if b is None else b.world
        raise NotImplementedError(
            f"a rescale from a zone on {wa} process(es) to one on {wb} "
            "whose meshes have no common parent group (a one-process zone "
            "and a split one, or two worlds): a split pool rescales onto a "
            "mesh over its own group or over another subgroup of its world")


class ZoneError(RuntimeError):
    """A worker of `spawn_zone` raised, died or hung."""


def _worker(fn, rank, world, store, group_timeout, args, conn):
    """A spawned process: join the group, run `fn`, send its result.  It
    leaves through `os._exit`: the group's threads would otherwise be
    torn down by the interpreter's exit, which can abort the process
    after its result was sent, and after a failure a peer may still be
    blocked in a collective."""
    code = 1
    try:
        group = init_zone_group(rank, world, store, group_timeout)
        out = fn(group, *args)
        group.barrier()                   # every worker is done with the group
        dist.destroy_process_group()
        conn.send(("ok", out))
        code = 0
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)


def spawn_zone(fn, world: int, *args, timeout: float = 900.0,
               group_timeout: float = GROUP_TIMEOUT_S) -> list:
    """Run `fn(group, *args)` in `world` spawned processes, each given its
    `ZoneGroup`, and return their results in rank order.  `fn` and `args`
    are pickled (`fn` by its import path).  Raises `ZoneError` if a worker
    raised, exited without a result, or any is still running after
    `timeout` seconds; every worker is stopped before this returns."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="zone-")
    store = os.path.join(tmp, "store")
    procs, pending = [], {}
    try:
        for rank in range(world):
            recv, send = ctx.Pipe(duplex=False)
            proc = ctx.Process(target=_worker, daemon=True, args=(
                fn, rank, world, store, group_timeout, args, send))
            proc.start()
            send.close()
            procs.append(proc)
            pending[recv] = rank
        results = [None] * world
        deadline = time.monotonic() + timeout
        while pending:
            left = deadline - time.monotonic()
            ready = (mp.connection.wait(list(pending), timeout=left)
                     if left > 0 else [])
            if not ready:
                raise ZoneError(
                    f"zone workers {sorted(pending.values())} still running "
                    f"after {timeout:g} s")
            for conn in ready:
                rank = pending.pop(conn)
                try:
                    status, value = conn.recv()
                except EOFError:
                    procs[rank].join(10)
                    raise ZoneError(
                        f"zone worker {rank} exited (code "
                        f"{procs[rank].exitcode}) with no result") from None
                if status != "ok":
                    raise ZoneError(f"zone worker {rank} raised:\n{value}")
                results[rank] = value
        for rank, proc in enumerate(procs):
            proc.join(max(deadline - time.monotonic(), 1.0))
            if proc.exitcode != 0:
                raise ZoneError(f"zone worker {rank} exited with code "
                                f"{proc.exitcode}")
        return results
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join()
        for conn in pending:
            conn.close()
        shutil.rmtree(tmp, ignore_errors=True)

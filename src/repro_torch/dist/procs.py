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
all-gather's block), the wall ms from the staging copy to the result
back on the device, and of those the ms of the two copies (`copy_ms`;
the rest is gloo's).  The sent bytes also go to the active cost counter
(kernels/cost.py) as the kind `process-exchange`.

A split zone runs the synchronous engine behind `Pool`, the deferred
engine (window > 1, bulk and patch) and the async commit ring
(pipeline_depth > 1, staged canaries), and every host of a pool on it:
`PoolGroup`, `Pool.rescale` / `elastic.reshard_state` between meshes
split over the same group, `runtime.Server` (data-parallel decode, each
process its block's rows of the batch) and `runtime.Trainer` (each
process its microbatches, the gradients folded in microbatch order).
Each reads and writes its process's block (`ZoneMesh.block_mesh`) and
makes only the exchanges its engine makes.  What stays refused: a
rescale that changes the process count (`refuse_regroup`: nothing makes
a new group), a split server whose batch G does not divide, a split
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

import torch
import torch.distributed as dist

from repro_torch.kernels import cost as kcost

GROUP_TIMEOUT_S = 120.0        # a collective that waits longer raises
CHUNK_BYTES = 1 << 28          # a large exchange's piece, a process


class ZoneGroup:
    """A gloo process group as the exchange layer of a split zone: `world`
    processes, this one `rank`, and the exchanges on device tensors."""

    def __init__(self, pg=None):
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
        self.stats = {"exchanges": 0, "staged_bytes": 0, "sent_bytes": 0,
                      "ms": 0.0, "copy_ms": 0.0}

    def __repr__(self) -> str:
        return f"ZoneGroup(rank={self.rank}, world={self.world})"

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
    return ZoneGroup(dist.group.WORLD)


def refuse_regroup(old_mesh, new_mesh) -> None:
    """Raise when a move from `old_mesh` to `new_mesh` changes the split:
    another process group, or none on one side, changes the process count,
    and nothing here makes a new group."""
    a = getattr(old_mesh, "group", None)
    b = getattr(new_mesh, "group", None)
    if (a is None) != (b is None) or (a is not None and a.pg is not b.pg):
        wa = 1 if a is None else a.world
        wb = 1 if b is None else b.world
        raise NotImplementedError(
            f"a rescale from a zone split over {wa} process(es) to one "
            f"split over {wb} changes the process count (or the group): a "
            "split pool rescales only onto a mesh split over its own group")


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

"""Async commit pipeline: `CommitTicket` futures and the N-deep `CommitRing`
(the reference's core/pipeline.py).

`Pool.commit_async` enqueues a commit and returns a `CommitTicket`, a
future over the commit's 0-d device verdict, instead of the verdict
itself.  Tickets queue in a `CommitRing` of `ProtectConfig.pipeline_depth`
slots: commit t + k is enqueued before commit t resolves, and `poll`
resolves whichever verdicts have landed, out of dispatch order.

A ticket is bookkeeping around a verdict the commit already produced, so a
pipeline drained at any boundary holds exactly what resolving every commit
at once would.  Readiness on the card comes from a `torch.cuda.Event`
recorded on the verdict's current stream when the ticket is made, right
after the commit was enqueued: `event.query()` reads it without waiting.
A verdict on the CPU or a host bool is always ready; any other object
answers through its own `is_ready()` (the tests' stand-ins).  `result()`
reads the verdict, with `.item()` for a tensor.

On a zone split over processes (dist/procs.py) the ticket needs no
exchange.  A split commit's exchanges synchronize the stream (each stages
its operand through the host), and a staged canary adds one more, its
agreement; so a dispatch blocks until its commit is done, and the pool
hands the ring a ticket that has `landed`: no event, ready at once on
every process, so that `poll` resolves the same tickets everywhere.  The
ring's overlap of dispatch and device work is lost there; exchanges that
stay on the device (NCCL, slice S7d) would bring it back.
"""
from __future__ import annotations

import time
from typing import Any, Callable, List, Optional

import torch

from repro_torch.obs.trace import layer


def _device_event(ok: Any) -> Optional["torch.cuda.Event"]:
    """An event recorded now on the current stream of a CUDA verdict's
    device (None for anything else)."""
    if not (isinstance(ok, torch.Tensor) and ok.is_cuda):
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(ok.device))
    return event


def _read(ok: Any) -> bool:
    return bool(ok.item()) if isinstance(ok, torch.Tensor) else bool(ok)


class CommitTicket:
    """One in-flight commit: the verdict future `commit_async` returns.

    Carries the unread verdict (`ok`), its readiness event (`event`, on the
    card), the dispatch / resolve wall-clock times, the trace span id of
    the dispatch event and optional `extras` (a wave's per-tenant
    verdicts).  `result()` reads the verdict, blocking unless it landed,
    and fires the resolve callback exactly once; `ready()` polls without
    blocking; `void()` resolves without trusting the device (a commit that
    a re-arm superseded).
    """

    __slots__ = ("seq", "ok", "event", "dispatched_at", "resolved_at",
                 "span_id", "extras", "staged", "landed", "voided",
                 "_verdict", "_on_resolve")

    def __init__(self, seq: int, ok: Any, *,
                 dispatched_at: Optional[float] = None,
                 span_id: Optional[int] = None,
                 extras: Optional[dict] = None,
                 staged: bool = False,
                 landed: bool = False,
                 on_resolve: Optional[Callable[["CommitTicket"], None]]
                 = None):
        self.seq = int(seq)
        self.ok = ok
        # landed: the verdict's stream was synchronized at dispatch (a
        # split zone), so it is ready and needs no event
        self.landed = bool(landed)
        self.event = None if self.landed else _device_event(ok)
        self.dispatched_at = (time.perf_counter() if dispatched_at is None
                              else float(dispatched_at))
        self.resolved_at: Optional[float] = None
        self.span_id = span_id
        self.extras = extras
        # staged: the verdict includes a canary checked on the device, which
        # the host could not know at dispatch (the Pool settles its abort
        # bookkeeping at resolution for these)
        self.staged = bool(staged)
        self.voided = False
        self._verdict: Optional[bool] = None
        self._on_resolve = on_resolve

    # -- state -----------------------------------------------------------------

    @property
    def resolved(self) -> bool:
        return self.resolved_at is not None

    @property
    def resolve_latency_ms(self) -> Optional[float]:
        """Dispatch-to-resolve wall (None while in flight)."""
        if self.resolved_at is None:
            return None
        return (self.resolved_at - self.dispatched_at) * 1e3

    def _landed(self) -> bool:
        if self.landed:
            return True
        if self.event is not None:
            return self.event.query()
        fn = getattr(self.ok, "is_ready", None)
        return True if fn is None else bool(fn())

    def ready(self) -> bool:
        """True iff `result()` would not block (resolved, or the verdict
        has landed)."""
        return self.resolved or self._landed()

    # -- resolution ------------------------------------------------------------

    def result(self, block: bool = True) -> Optional[bool]:
        """The commit verdict.  None when `block=False` and the verdict has
        not landed; otherwise reads it (at most once) and returns the
        bool."""
        if self.resolved:
            return self._verdict
        if not block and not self._landed():
            return None
        self._finish(_read(self.ok))
        return self._verdict

    def void(self, verdict: bool = False) -> bool:
        """Resolve without consulting the device (a fixed verdict for a
        superseded commit); a no-op once resolved."""
        if not self.resolved:
            self.voided = True
            self._finish(bool(verdict))
        return bool(self._verdict)

    def _finish(self, verdict: bool) -> None:
        self._verdict = verdict
        self.resolved_at = time.perf_counter()
        if self._on_resolve is not None:
            cb, self._on_resolve = self._on_resolve, None
            cb(self)

    def __repr__(self) -> str:  # debugging aid, not a stable format
        state = ("voided" if self.voided else
                 repr(self._verdict) if self.resolved else "in-flight")
        return f"CommitTicket(seq={self.seq}, {state})"


class CommitRing:
    """The N-deep in-flight window (`ProtectConfig.pipeline_depth`).

    `submit` enqueues a ticket, first force-resolving the oldest when the
    ring is full (back-pressure: never more than `depth` unresolved
    commits).  `poll` resolves every ticket whose verdict landed, out of
    dispatch order; `drain` resolves all of them in dispatch order (the
    boundary that flush, scrub and recovery take).  `on_depth` fires with
    the in-flight count whenever it changes.
    """

    def __init__(self, depth: int = 1, *,
                 on_depth: Optional[Callable[[int], None]] = None):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self._inflight: List[CommitTicket] = []
        self._on_depth = on_depth

    def __len__(self) -> int:
        return len(self._inflight)

    @property
    def in_flight(self) -> List[CommitTicket]:
        """The unresolved tickets, oldest first (a copy)."""
        return list(self._inflight)

    def _note_depth(self) -> None:
        if self._on_depth is not None:
            self._on_depth(len(self._inflight))

    def submit(self, ticket: CommitTicket) -> CommitTicket:
        """Enqueue; force-resolves the oldest ticket when full."""
        if len(self._inflight) >= self.depth:
            with layer("ring.wait"):
                while len(self._inflight) >= self.depth:
                    self._inflight.pop(0).result()
        self._inflight.append(ticket)
        self._note_depth()
        return ticket

    def poll(self) -> List[CommitTicket]:
        """Resolve every ticket whose verdict already landed, out of
        dispatch order, and return them (possibly none)."""
        done = [t for t in self._inflight if t.ready()]
        if done:
            self._inflight = [t for t in self._inflight if t not in done]
            for t in done:
                t.result()
            self._note_depth()
        return done

    def drain(self) -> List[CommitTicket]:
        """Resolve every in-flight ticket, in dispatch order."""
        done, self._inflight = self._inflight, []
        if done:
            with layer("ring.wait"):
                for t in done:
                    t.result()
        self._note_depth()
        return done

    def void_all(self, verdict: bool = False) -> List[CommitTicket]:
        """Void every in-flight ticket (see `CommitTicket.void`), for
        boundaries whose device verdicts were superseded."""
        done, self._inflight = self._inflight, []
        for t in done:
            t.void(verdict)
        self._note_depth()
        return done

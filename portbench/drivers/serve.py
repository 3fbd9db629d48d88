"""A model served with its state protected: `runtime.Server`, greedy,
every sequence of the batch decoding one token a step (a closed loop).

Set-up makes the weights on the device from the seed (one draw for every
random leaf, each leaf scaled and cast to the dtype it is served in),
opens the server over the configuration's mesh and protection, prefills
the mix's prompts (made from the seed) and warms the decode.  The window
runs `Server.step` and reads each step's tokens on the host.

The check, once the window has closed: the pool's row, syndromes,
Fletcher table and digests against the plain zone reference over the
state it holds; then, with the program freed and the weights made again
from the seed, the plain f32 model over every sequence with the tokens
it was served, and by how far each served token's logit lies below the
best one, as a share of the largest logit: the mean over every served
position is compared (the widest gap is read beside it, not compared:
it did not separate the program from the control).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from portbench import harness

CHECKED = 1024


def family(cfg: dict):
    """The configuration's model family: its weights and plain reference
    (`reference/<family>.py`)."""
    return harness.load_module(harness.HERE / "reference" /
                               f"{cfg['family']}.py",
                               f"portbench_family_{cfg['family']}")


def model_config(cfg: dict):
    from repro_torch.configs.registry import get_config
    m = dict(cfg["model"], block_pattern=tuple(cfg["model"]["block_pattern"]))
    return dataclasses.replace(get_config(cfg["arch"]), **m)


class Cell:
    def __init__(self, cfg: dict, mix: dict, device, seed: int, spans):
        self.cfg, self.mix, self.dev, self.seed = cfg, mix, device, seed
        self.spans = spans
        self.planted = None

    def plant(self, fault: str) -> None:
        """Break the timed path underneath (for the tests of the check):
        "unchanged" - a step that hands back its input tokens and leaves
        the state; "altered" - the served tokens of one sequence changed
        where they are produced; "half" - half of the batch's rows decoded
        from the other half's state; "fp8" - the control: the check
        judges the tokens the reference in float8 puts first in place of
        the served ones (nothing broken)."""
        if fault not in ("unchanged", "altered", "half", "fp8"):
            raise ValueError(f"no planted fault {fault!r}")
        self.planted = fault

    def setup(self) -> None:
        from repro_torch import ProtectConfig, ZoneMesh
        from repro_torch.kernels import _build
        from repro_torch.runtime.server import Server
        if self.dev.type == "cuda":
            _build.build()
        cfg, s = self.cfg, self.cfg["serve"]
        self.fam = family(cfg)
        params = self.fam.make_weights(cfg, self.seed, self.dev)
        self.mcfg = model_config(cfg)
        mesh = ZoneMesh(tuple(s["mesh"]), ("data", "model"))
        self.srv = Server(self.mcfg, ProtectConfig(**s["protect"]), mesh,
                          batch=s["batch"], max_len=s["max_len"],
                          device=self.dev)
        self.srv.start(params)
        del params
        gen = torch.Generator(device=self.dev)
        gen.manual_seed((self.seed + 1) & ((1 << 63) - 1))
        self.prompt = torch.randint(
            0, cfg["model"]["vocab"], (s["batch"], self.mix["prompt_len"]),
            generator=gen, device=self.dev)
        tok = self.srv.prefill(self.prompt)
        self.served = [tok.cpu()]
        for _ in range(self.mix["warmup_steps"]):
            tok = self.srv.step(tok)
            self.served.append(tok.cpu())
        self.tok = tok
        if self.planted is not None:
            self._break()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def _break(self) -> None:
        srv, fault, step = self.srv, self.planted, self.srv.step
        if fault == "unchanged":
            srv.step = lambda tokens: tokens
        elif fault == "altered":
            def altered(tokens):
                out = step(tokens).clone()
                out[0] = (out[0] + 1) % self.cfg["model"]["vocab"]
                return out
            srv.step = altered
        elif fault == "half":
            def half(tokens):
                out = step(tokens).clone()
                b = out.shape[0] // 2
                out[b:] = out[:out.shape[0] - b]
                return out
            srv.step = half

    def mark(self, steps: int, t: float = None) -> dict:
        """The counts the window's record is taken from, and the clock
        (read after them unless given)."""
        pool = self.srv.pool
        hist = pool.metrics.histogram("pool_commit_dispatch_ms")
        out = {"hist": (hist.sum, hist.count), "steps": steps,
               "aborted": pool.stats()["aborted_commits"]}
        return dict(out, t=time.perf_counter() if t is None else t)

    def window(self, seconds: float, tick=None) -> dict:
        """The closed loop for `seconds`.  In a traced run `tick()` comes
        after each step, and the record's clocks and counts are those
        after the call that stopped the trace (none if it never did);
        `attempted` and `failed` are always the whole window's."""
        start = self.mark(0)
        since = start if tick is None else None
        steps_ms, tok = [], self.tok
        while time.perf_counter() - start["t"] < seconds:
            with self.spans("step"):
                ts = time.perf_counter()
                tok = self.srv.step(tok)
                host = tok.cpu()
                steps_ms.append((time.perf_counter() - ts) * 1e3)
            self.served.append(host)
            if tick is not None and tick():
                since = self.mark(len(steps_ms))
        end = self.mark(len(steps_ms), time.perf_counter())
        since = since or end
        B = self.cfg["serve"]["batch"]
        return {"window_s": end["t"] - since["t"],
                "tokens": B * (end["steps"] - since["steps"]),
                "step_ms": steps_ms[since["steps"]:],
                "dispatch_ms": (end["hist"][0] - since["hist"][0],
                                end["hist"][1] - since["hist"][1]),
                "flops_per_token": self.fam.decode_flops(self.cfg),
                "attempted": B * end["steps"],
                "failed": B * (end["aborted"] - start["aborted"])}

    def sequences(self) -> tuple:
        """(every sequence: prompt and served tokens, (B, S)); the token
        served after each position from the prompt's last on.  At most
        CHECKED tokens a sequence, from the first (a sound window serves
        fewer; a broken one that returns at once serves millions)."""
        served = torch.stack(self.served[:CHECKED], 1)       # (B, n)
        seq = torch.cat([self.prompt.cpu(), served[:, :-1]], 1)
        return seq, served

    def check(self, fault: str = None) -> dict:
        from portbench.reference import zone as ref
        ref_model = self.fam
        pool = self.srv.pool
        prot = pool.prot
        s = self.cfg["serve"]
        specs = {k: list(v) for k, v in _flat(self.srv.model.cache_specs(
            s["batch"], s["max_len"], self.srv.mesh)).items()}
        mesh = self.cfg["serve"]["mesh"]
        z = ref.Zone(_flat(pool.state), specs,
                     sizes={"data": mesh[0], "model": mesh[1]},
                     bw=self.cfg["serve"]["protect"]["block_words"],
                     r=self.cfg["serve"]["protect"]["redundancy"],
                     device=self.dev)
        off = ref.compare(z, {"row": prot.row, "synd": prot.synd,
                              "cksums": prot.cksums, "digest": prot.digest})
        report = pool.scrub()
        off["scrub_flags"] = int(bool(report.suspect)) + sum(
            1 for v in (report.synd_ok or []) if not v)
        del z, prot, pool
        self.free()
        params = ref_model.make_weights(self.cfg, self.seed, self.dev)
        seq, served = self.sequences()
        P = self.prompt.shape[1]
        logits = ref_model.forward(self.cfg["model"], params, seq.to(self.dev))
        gaps = ref_model.served_gaps(logits[:, P - 1:],
                                     served.to(self.dev))
        self.readings = dict(gap_stats("served", gaps),
                             positions=int(gaps.numel()))
        if fault == "fp8":
            # the control in the program's place: at each position the
            # token the fp8 reference puts first, judged as a served one
            ctrl = ref_model.forward(self.cfg["model"], params,
                                     seq.to(self.dev), weights="fp8")
            gaps = ref_model.served_gaps(logits[:, P - 1:],
                                         ctrl[:, P - 1:].argmax(-1))
            self.readings.update(gap_stats("control", gaps))
        out = {k: (v, 0) for k, v in off.items()}
        out["served_gap_mean"] = (float(gaps.mean()), self.gap_limit())
        return out

    def gap_limit(self) -> float:
        return harness.load_json(harness.HERE / "reference" / "limits" / (
            self.cfg["name"] + ".json"))["served_gap_mean"]

    def free(self) -> None:
        if getattr(self, "srv", None) is not None:
            self.srv = None
            if self.dev.type == "cuda":
                torch.cuda.empty_cache()


def gap_stats(tag: str, gaps: torch.Tensor) -> dict:
    """The widest, the mean and the share of positions whose token is not
    the reference's best."""
    return {f"{tag}_gap": float(gaps.max()),
            f"{tag}_gap_mean": float(gaps.mean()),
            f"{tag}_not_best": float((gaps > 0).float().mean())}


def _flat(tree, pre=()) -> dict:
    """A nested dict's leaves by their '/'-joined key path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, pre + (k,)))
        return out
    return {"/".join(pre): tree}

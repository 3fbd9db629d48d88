"""Plain f32 reference of the served xLSTM[7:1] (arXiv:2405.04517), apart
from the program: no cache, no chunking, no batching tricks; each layer's
weights widened to f32 as it runs, so no f32 copy of the model is made.
On the card every product runs in f32 proper (TF32 off).

The blocks are those of the configuration as the program serves it: the
mLSTM with projection factor 2, a causal width-4 depthwise conv, per-head
block-diagonal q / k / v (head-size blocks), exponential input and
sigmoid forget gates from the conv's output, the matrix memory stepped a
position at a time with its stabilizer m, an output norm, the z gate and
the down projection; the sLSTM with its four gates from the input and the
previous h (block-diagonal r_h), exponential input gate, an output norm
and its projection; RMS norms before every block and at the end, an
untied unembedding.  Departures from the paper are listed in PERF.md.

The weights are the benchmark's input, made here from the seed
(`make_weights`) and handed to the program and to this reference alike.

`forward(..., weights="fp8")` is the control: every matrix cast to
float8 e4m3 (one scale a tensor, amax / 448) and back before use.
"""
from __future__ import annotations

import contextlib
import math

import torch

from portbench.reference import yardstick

F = torch.nn.functional
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """f32 products with no TF32 on the card."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


F32_LEAVES = ("scale", "b_if", "outnorm", "r_h", "bias")


def weight_defs(cfg: dict) -> dict:
    """Every weight of the served xLSTM: key path -> (shape, init, std),
    init "normal" (std given), "zeros" or "ones"; conditioned as a trained
    model's (the configuration's `assumed`)."""
    m = cfg["model"]
    D, H, V, L = m["d_model"], m["n_heads"], m["vocab"], m["n_layers"]
    pattern = m["block_pattern"]
    G = L // len(pattern)
    di = cfg["mlstm_proj_factor"] * D
    dm, ds, k = di // H, D // H, cfg["conv_kernel"]
    out_scale = 1 / math.sqrt(2 * L)
    defs = {("embed", "tok"): ((V, D), "normal", 1.0),
            ("embed", "unembed"): ((D, V), "normal", 1 / math.sqrt(D)),
            ("final_norm", "scale"): ((D,), "ones", 0)}
    for j, t in enumerate(pattern):
        pre = ("groups", f"b{j}_{t}", "cell")
        if t == "mlstm":
            cell = {("norm", "scale"): ((D,), "ones", 0),
                    ("w_up",): ((D, 2 * di), "normal", 1 / math.sqrt(D)),
                    ("w_down",): ((di, D), "normal",
                                  out_scale / math.sqrt(di)),
                    ("conv_w",): ((k, di), "normal", 0.1),
                    ("conv_b",): ((di,), "zeros", 0),
                    ("wq",): ((H, dm, dm), "normal", 1 / math.sqrt(dm)),
                    ("wk",): ((H, dm, dm), "normal", 1 / math.sqrt(dm)),
                    ("wv",): ((H, dm, dm), "normal", 1 / math.sqrt(dm)),
                    ("w_if",): ((di, 2 * H), "normal", 0.02),
                    ("b_if",): ((2 * H,), "zeros", 0),
                    ("outnorm",): ((di,), "ones", 0)}
        else:
            cell = {("norm", "scale"): ((D,), "ones", 0),
                    ("w_in",): ((D, 4, H, ds), "normal", 1 / math.sqrt(D)),
                    ("r_h",): ((H, ds, 4, ds), "normal", 0.02),
                    ("bias",): ((4, H, ds), "zeros", 0),
                    ("w_out",): ((D, D), "normal",
                                 out_scale / math.sqrt(D)),
                    ("outnorm",): ((D,), "ones", 0)}
        for path, (shape, init, std) in cell.items():
            defs[pre + path] = ((G,) + shape, init, std)
    return defs


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The weights as a nested dict, made on the device from the seed: one
    normal draw for every random leaf, sliced, scaled and cast."""
    defs = weight_defs(cfg)
    serve_dt = getattr(torch, cfg["model"]["compute_dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 63) - 1))
    total = sum(math.prod(s) for s, init, _ in defs.values()
                if init == "normal")
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for path in sorted(defs):
        shape, init, std = defs[path]
        dt = torch.float32 if path[-1] in F32_LEAVES else serve_dt
        if init == "normal":
            n = math.prod(shape)
            w = draw[at:at + n].view(shape).mul_(std).to(dt)
            at += n
        else:
            w = (torch.zeros if init == "zeros" else torch.ones)(
                shape, dtype=dt, device=device)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = w
    del draw
    return out


def decode_flops(cfg: dict) -> int:
    """Model FLOPs a decoded token (the frozen yardstick)."""
    return yardstick.xlstm_decode_flops(dict(cfg["model"], **{
        k: cfg[k] for k in ("mlstm_proj_factor", "conv_kernel")}))[
        "flops_per_token"]


def widen(w: torch.Tensor, weights: str) -> torch.Tensor:
    """A weight as the reference reads it: f32, or (the control) through
    float8 e4m3 with one scale for the tensor."""
    w = w.float()
    if weights == "f32" or w.dim() < 2:
        return w
    scale = w.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def norm(x, scale):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * scale


def conv(u, w, b):
    """Causal depthwise conv of width w.shape[0] over (B, S, C)."""
    width, ch = w.shape
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return F.conv1d(F.pad(u.transpose(1, 2), (width - 1, 0)),
                        w.T[:, None, :], b, groups=ch).transpose(1, 2)


def mlstm(c, x):
    """An mLSTM block's residual branch: (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    H, dh = c["wq"].shape[0], c["wq"].shape[1]
    di = H * dh
    up = norm(x, c["norm"]["scale"]) @ c["w_up"]
    xin, z = up[..., :di], up[..., di:]
    u = F.silu(conv(xin, c["conv_w"], c["conv_b"]))
    q = torch.einsum("bshe,hef->bshf", u.reshape(B, S, H, dh),
                     c["wq"]) / math.sqrt(dh)
    k = torch.einsum("bshe,hef->bshf", u.reshape(B, S, H, dh), c["wk"])
    v = torch.einsum("bshe,hef->bshf", xin.reshape(B, S, H, dh), c["wv"])
    g = u @ c["w_if"] + c["b_if"]
    ig, lf = g[..., :H], F.logsigmoid(g[..., H:])
    C = x.new_zeros((B, H, dh, dh))
    n = x.new_zeros((B, H, dh))
    m = x.new_full((B, H), -1e30)
    hs = []
    for t in range(S):
        m_new = torch.maximum(lf[:, t] + m, ig[:, t])
        ip = torch.exp(ig[:, t] - m_new)[..., None]
        fp = torch.exp(lf[:, t] + m - m_new)[..., None]
        C = fp[..., None] * C + ip[..., None] * (
            k[:, t, :, :, None] * v[:, t, :, None, :])
        n = fp * n + ip * k[:, t]
        m = m_new
        num = torch.einsum("bhd,bhde->bhe", q[:, t], C)
        den = torch.einsum("bhd,bhd->bh", q[:, t], n)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m))[..., None])
    h = norm(torch.stack(hs, 1).reshape(B, S, di), c["outnorm"])
    return (h * F.silu(z)) @ c["w_down"]


def slstm(c, x):
    """An sLSTM block's residual branch: (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    gx = torch.einsum("bsd,dghe->bsghe", norm(x, c["norm"]["scale"]),
                      c["w_in"])
    H, dh = gx.shape[3], gx.shape[4]
    cs = x.new_zeros((B, H, dh))
    h = x.new_zeros((B, H, dh))
    n = x.new_zeros((B, H, dh)) + 1e-6
    m = x.new_full((B, H, dh), -1e30)
    hs = []
    for t in range(S):
        g = gx[:, t] + torch.einsum("bhd,hdge->bghe", h, c["r_h"]) + c["bias"]
        lf = F.logsigmoid(g[:, 2])
        m_new = torch.maximum(lf + m, g[:, 1])
        ip, fp = torch.exp(g[:, 1] - m_new), torch.exp(lf + m - m_new)
        cs = fp * cs + ip * torch.tanh(g[:, 0])
        n = fp * n + ip
        h = torch.sigmoid(g[:, 3]) * cs / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return norm(torch.stack(hs, 1).reshape(B, S, D), c["outnorm"]) @ c[
        "w_out"]


def layers(cfg: dict, params: dict):
    """(block type, block weights) of every layer in order; `cfg` the
    configuration file's `model` entry."""
    pattern = cfg["block_pattern"]
    for i in range(cfg["n_layers"] // len(pattern)):
        for j, t in enumerate(pattern):
            yield t, _map(lambda w: w[i], params["groups"][f"b{j}_{t}"])


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def forward(cfg: dict, params: dict, seq: torch.Tensor,
            weights: str = "f32") -> torch.Tensor:
    """f32 logits of every position: (B, S) token ids -> (B, S, V)."""
    with exact_f32(), torch.no_grad():
        x = params["embed"]["tok"][seq.long()].float()
        for t, p in layers(cfg, params):
            p = _map(lambda w: widen(w, weights), p)["cell"]
            x = x + (mlstm(p, x) if t == "mlstm" else slstm(p, x))
        x = norm(x, params["final_norm"]["scale"].float())
        return x @ widen(params["embed"]["unembed"], weights)


def served_gaps(logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """For each position, how far the served next token's logit lies below
    the best one, as a share of the largest |logit| of the whole run.
    `logits` (B, S, V) of the sequence, `served` (B, S) the token that was
    served after each position."""
    best = logits.amax(-1)
    got = logits.gather(-1, served.long()[..., None])[..., 0]
    return (best - got) / logits.abs().amax()

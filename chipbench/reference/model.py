"""Plain reference of the benchmark's MoE transformer, in float32.

Written from the model's published semantics, in plain PyTorch, with no
kernel, cache or batching of the program under test: token embedding, then
per layer a pre-norm GQA attention with interleaved RoPE and a causal mask,
and a pre-norm top-k routed SwiGLU expert layer; a final RMSNorm and the
output head.  The loss is the mean next-token NLL plus 0.01 times the
layers' mean switch-style load-balance loss.

The expert layer is the expert-parallel one that the configuration states:
``ep`` ranks, each holding ``n_experts / ep`` experts and the contiguous
``1 / ep`` of the batch's tokens.  Each rank's assignments, token-major
(a token's top-k in descending order), fill a buffer per destination rank
of ``capacity`` slots; an assignment past its buffer is dropped and adds
nothing, and the kept ones are summed with their renormalised gate
weights.  Which fabric paths carry the rows does not change the result,
so no planner is modelled.

``prec="fp8"`` is the control: every product's operands and result
rounded to float8 e4m3 with one scale a tensor (its absolute maximum at
448), in the backward too.  ``prec="f32"`` is the reference; TF32 is off
(:func:`exact`).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

F32 = torch.float32
E4M3_MAX = 448.0


def exact() -> None:
    """float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def q8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (its absolute maximum at
    448), back in float32."""
    s = t.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).to(F32) * s


class _Q8Matmul(torch.autograd.Function):
    """``q8(q8(a) @ q8(b))``; its backward's two products rounded alike."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = q8(a), q8(b)
        ctx.save_for_backward(qa, qb)
        return q8(qa @ qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = q8(g)
        ga = q8(qg @ qb.transpose(-1, -2))
        gb = q8(qa.transpose(-1, -2) @ qg)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    return a @ b if prec == "f32" else _Q8Matmul.apply(a, b)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, H, S, dh]; interleaved pairs rotated by position."""
    dh, s = x.shape[-1], x.shape[-2]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=F32, device=x.device) / dh))
    ang = torch.arange(s, device=x.device, dtype=F32)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).reshape(x.shape)


#: query rows a block of the attention's score products
Q_BLOCK = 512


def attention(p: Dict[str, torch.Tensor], h: torch.Tensor, cfg: dict, prec: str):
    """Causal GQA attention of the normed input h [B, S, D] -> [B, S, D],
    by blocks of query rows (each over the keys it may see)."""
    b, s, d = h.shape
    H, Hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    hf = h.reshape(b * s, d)
    q = mm(hf, p["wq"], prec).view(b, s, H, dh).transpose(1, 2)
    k = mm(hf, p["wk"], prec).view(b, s, Hkv, dh).transpose(1, 2)
    v = mm(hf, p["wv"], prec).view(b, s, Hkv, dh).transpose(1, 2)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    scale = math.sqrt(dh)
    outs = []
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(q0 + Q_BLOCK, s)
        sc = mm(q[:, :, q0:q1], k[:, :, :q1].transpose(-1, -2), prec) / scale
        mask = torch.arange(q1, device=h.device)[None, :] <= torch.arange(
            q0, q1, device=h.device)[:, None]
        pr = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(mm(pr, v[:, :, :q1], prec))
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(b * s, H * dh)
    return mm(o, p["wo"], prec).view(b, s, d)


def route(z: torch.Tensor, top_k: int):
    """Router logits z [N, E] (float32) -> (probs, top_idx [N, k], gate [N, k])."""
    probs = torch.softmax(z, dim=-1)
    top_w, top_idx = torch.topk(probs, top_k, dim=-1)
    return probs, top_idx, top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)


def capacity(n_tokens: int, cfg: dict) -> int:
    """Slots of one rank's buffer for one destination rank."""
    a = n_tokens // cfg["ep"] * cfg["top_k"]
    per_dest = math.ceil(a / cfg["ep"] * cfg["capacity_factor"])
    ct = cfg["chunk_tokens"]
    return math.ceil(per_dest / ct) * ct


def kept(top_idx: torch.Tensor, cfg: dict) -> torch.Tensor:
    """[N, k] bool: each assignment that its source rank's buffer for the
    destination rank holds (the first ``capacity`` in token-major order)."""
    n_tok, k = top_idx.shape
    n = cfg["ep"]
    dest = (top_idx // (cfg["n_experts"] // n)).reshape(n, n_tok // n * k)
    seen = torch.cumsum(F.one_hot(dest, n), dim=1)
    pos = torch.gather(seen, 2, dest[..., None])[..., 0] - 1
    return (pos < capacity(n_tok, cfg)).view(n_tok, k)


def experts(p, h: torch.Tensor, top_idx, gate, keep, prec: str) -> torch.Tensor:
    """The kept assignments through their experts' SwiGLU, gate-weighted and
    summed per token: h [N, D] -> [N, D]."""
    y = torch.zeros_like(h)
    for e in range(p["wg"].shape[0]):
        tok, slot = torch.nonzero((top_idx == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = h[tok]
        a = F.silu(mm(xe, p["wg"][e], prec)) * mm(xe, p["wu"][e], prec)
        y = y.index_add(0, tok, mm(a, p["wd"][e], prec) * gate[tok, slot, None])
    return y


def _layer_params(params, i: int) -> Dict[str, torch.Tensor]:
    blk = params["blocks"]
    out = {k: v[i] for k, v in blk.items() if k != "attn"}
    out.update({k: v[i] for k, v in blk["attn"].items()})
    return out


def _block(p, x: torch.Tensor, cfg: dict, prec: str):
    """One layer: x [B, S, D] -> (x, aux, drops)."""
    b, s, d = x.shape
    eps = cfg["norm_eps"]
    x = x + attention(p, rms_norm(x, p["ln1"], eps), cfg, prec)
    h = rms_norm(x, p["ln2"], eps).reshape(b * s, d)
    z = h @ p["router"]                                    # float32, as served
    probs, top_idx, gate = route(z, cfg["top_k"])
    keep = kept(top_idx, cfg)
    frac = torch.bincount(top_idx.reshape(-1), minlength=cfg["n_experts"]).to(F32)
    aux = cfg["n_experts"] * torch.sum(frac / top_idx.numel() * probs.mean(0))
    y = experts(p, h, top_idx, gate, keep, prec)
    return x + y.view(b, s, d), aux, (~keep).sum()


def loss(params, tokens: torch.Tensor, labels: torch.Tensor, cfg: dict, prec: str = "f32",
         stats: Optional[dict] = None) -> torch.Tensor:
    """Mean next-token NLL + 0.01 x the layers' mean load-balance loss.

    ``params``: float32 leaves.  Layers after the first are recomputed in
    the backward (``torch.utils.checkpoint``), so one layer's graph lives at
    a time.  ``stats`` gains the dropped assignments under ``dropped``."""
    x = params["embed"][tokens]
    auxs = []
    for i in range(cfg["n_layers"]):
        p = _layer_params(params, i)
        if cfg["n_layers"] > 1 and torch.is_grad_enabled():
            x, aux, drops = torch.utils.checkpoint.checkpoint(
                _block, p, x, cfg, prec, use_reentrant=False)
        else:
            x, aux, drops = _block(p, x, cfg, prec)
        auxs.append(aux)
        if stats is not None:
            stats["dropped"] = stats.get("dropped", 0) + int(drops)
    b, s, d = x.shape
    h = rms_norm(x, params["final_norm"], cfg["norm_eps"]).reshape(b * s, d)
    return nll_sum(h, params["lm_head"], labels.reshape(-1), prec) / (b * s) \
        + 0.01 * torch.stack(auxs).mean()


def nll_sum(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor, prec: str):
    """The summed next-token NLL of the final hidden rows h [N, D], by
    blocks of rows (256 MB of float32 logits a block)."""
    nll = torch.zeros((), dtype=F32, device=h.device)
    rows = max(1, (1 << 28) // (4 * head.shape[1]))
    for r0 in range(0, h.shape[0], rows):
        z = mm(h[r0:r0 + rows], head, prec)
        nll = nll + (torch.logsumexp(z, -1) - z.gather(1, labels[r0:r0 + rows, None])[:, 0]).sum()
    return nll


# -- the served model: judged under the routings that rounding could give -------

#: router logits closer than this to the top-k boundary may fall either way
#: under bfloat16 rounding of the router's input: three times the largest
#: gap of a served router logit from the reference's measured at the cells'
#: size (0.0242, over 9 batches of 3 seeds)
ROUTE_TOL = 0.075


def _possible(z: torch.Tensor, k: int, tol: float):
    """Per token: (experts certainly in the top-k, experts possibly in it)."""
    srt = torch.sort(z, dim=-1, descending=True).values
    certain = z > srt[:, k:k + 1] + tol
    possible = z >= srt[:, k - 1:k] - tol
    return certain, possible


def served(params, tokens: torch.Tensor, rows: torch.Tensor, cfg: dict, prec: str = "f32"):
    """What a server in the program's place hands over for tokens [B, S]:
    (the last positions' logits [B, V], the last layer's expert-layer output
    at the flat token rows ``rows`` [R, D], the assignments dropped)."""
    b, s = tokens.shape
    x = params["embed"][tokens]
    dropped = 0
    for i in range(cfg["n_layers"]):
        p = _layer_params(params, i)
        x = x + attention(p, rms_norm(x, p["ln1"], cfg["norm_eps"]), cfg, prec)
        h = rms_norm(x, p["ln2"], cfg["norm_eps"]).reshape(b * s, -1)
        _, top_idx, gate = route(h @ p["router"], cfg["top_k"])
        keep = kept(top_idx, cfg)
        y = experts(p, h, top_idx, gate, keep, prec)
        dropped += int((~keep).sum())
        x = x + y.view(x.shape)
    hl = rms_norm(x[:, -1], params["final_norm"], cfg["norm_eps"])
    return mm(hl, params["lm_head"], prec), y[rows], dropped


class Judge:
    """The plain reference's reading of one served batch tokens [B, S], in
    float32, against which a server's answers are judged: its last layer's
    routing is taken as any that rounding could give (a top-k choice within
    :data:`ROUTE_TOL` of the boundary; a buffer slot that such choices of
    earlier tokens on the rank could fill or leave free).

    ``rows``: the flat token rows whose expert-layer output is judged (the
    last position of every prompt among them)."""

    def __init__(self, params, tokens: torch.Tensor, rows, cfg: dict):
        b, s = tokens.shape
        eps, k, n = cfg["norm_eps"], cfg["top_k"], cfg["ep"]
        self.cfg, self.rows = cfg, [int(r) for r in rows]
        x = params["embed"][tokens]
        before = 0
        for i in range(cfg["n_layers"] - 1):
            x, _, drops = _block(_layer_params(params, i), x, cfg, "f32")
            before += int(drops)
        p = _layer_params(params, cfg["n_layers"] - 1)
        x = x + attention(p, rms_norm(x, p["ln1"], eps), cfg, "f32")
        x = x.reshape(b * s, -1)
        h = rms_norm(x, p["ln2"], eps)
        probs = torch.softmax(h @ p["router"], dim=-1)
        certain, possible = _possible(h @ p["router"], k, ROUTE_TOL)
        dest = F.one_hot(torch.arange(cfg["n_experts"], device=x.device)
                         // (cfg["n_experts"] // n), n).to(F32)
        lo_t = (certain.to(F32) @ dest).view(n, -1, n)                 # [rank, token, dest]
        hi_t = torch.clamp(possible.to(F32) @ dest, max=float(k)).view(n, -1, n)
        cap = capacity(b * s, cfg)
        # the assignments dropped: each (rank, destination) buffer drops what
        # passes its capacity, and holds at least the certain assignments and
        # at most the possible ones
        self.drops = (before + int(torch.clamp(lo_t.sum(1) - cap, min=0).sum()),
                      before + int(torch.clamp(hi_t.sum(1) - cap, min=0).sum()))
        # each judged row's possible outputs, from its top-k choices and fates
        r_idx = torch.as_tensor(self.rows, device=x.device)
        hr = h[r_idx]
        ys = torch.stack([mm(F.silu(hr @ p["wg"][e]) * (hr @ p["wu"][e]), p["wd"][e], "f32")
                          for e in range(cfg["n_experts"])], 1)        # [R, E, D]
        lo_c = torch.cumsum(lo_t, 1) - lo_t       # assignments before each token, per dest
        hi_c = torch.cumsum(hi_t, 1) - hi_t
        per = (b * s) // n
        self.options = []                                               # [R] of [O, D]
        for j, t in enumerate(self.rows):
            lo, hi = lo_c[t // per, t % per].tolist(), hi_c[t // per, t % per].tolist()
            opts = []
            sure = torch.nonzero(certain[t]).flatten().tolist()
            maybe = [e for e in torch.nonzero(possible[t]).flatten().tolist() if e not in sure]
            for extra in itertools.combinations(maybe, k - len(sure)):
                chosen = sorted(sure + list(extra), key=lambda e: -float(probs[t, e]))
                w = probs[t, chosen] / probs[t, chosen].sum().clamp_min(1e-9)
                fates, seen = [], {}
                for e in chosen:             # each assignment kept, dropped, or either
                    d = e // (cfg["n_experts"] // n)
                    at = seen.get(d, 0)
                    seen[d] = at + 1
                    fates.append([True] if hi[d] + at < cap else
                                 [False] if lo[d] + at >= cap else [True, False])
                for keep in itertools.product(*fates):
                    y = torch.zeros_like(x[t])
                    for e, wt, kp in zip(chosen, w, keep):
                        if kp:
                            y = y + ys[j, e] * wt
                    opts.append(y)
            self.options.append(torch.stack(opts))
        norms = [float(o.norm(dim=-1).max()) for o in self.options]
        self.scale = max(float(torch.tensor(norms).median()), 1e-30)
        # the last positions' logits under each of their rows' outputs
        self.last = {}
        for row in range(b):
            t = row * s + s - 1
            if t in self.rows:
                opts = self.options[self.rows.index(t)]
                self.last[row] = mm(rms_norm(x[t] + opts, params["final_norm"], eps),
                                    params["lm_head"], "f32")

    def score(self, tokens, y_rows, dropped: int) -> dict:
        """The served batch's numbers: ``gap``, the widest gap by which a
        served token's logit lies below the best, least over the routings;
        ``moe_gap``, the widest distance of a judged row's expert-layer
        output from the nearest of its possible outputs, over the median
        row's norm; ``drops_out``, the assignments by which ``dropped`` lies
        outside what the possible routings drop.  ``y_rows`` None (the rows
        were not all produced) reads ``moe_gap`` inf."""
        gap = 0.0
        for row, zl in self.last.items():
            tok = int(tokens[row])
            gap = max(gap, float((zl.max(-1).values - zl[:, tok]).min()))
        if y_rows is None:
            moe = float("inf")
        else:
            y = torch.as_tensor(y_rows, device=self.options[0].device).float()
            moe = max(float((o - y[j]).norm(dim=-1).min()) for j, o in enumerate(self.options))
            moe /= self.scale
        lo, hi = self.drops
        return {"gap": gap, "moe_gap": moe, "drops_out": float(max(0, lo - dropped, dropped - hi))}

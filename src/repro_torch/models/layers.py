"""Layers of the architecture zoo as ``nn.Module``s (port of
``repro.models.layers``).

Conventions, as in the reference:

* every module holds fp32 parameters with the reference's names and shapes
  (``Attention.wq`` is (d, H, hd), ``wo`` (H, hd, d), …), so
  ``bridge.model_from_numpy`` can carry the reference's tree across leaf by
  leaf; parameters start at zero (the reference's init of norms and
  biases), and a module's ``init_(generator)`` draws its other direct
  parameters from the reference's distributions and scales;
* activations are (B, S, D); decode passes S = 1 and a cache;
* compute happens in ``x.dtype``: each weight is cast to it at its use, as
  the reference does, so bf16 means the same thing in both packages; norms
  and softmax run in fp32;
* a cache is a dict of tensors per layer; a step returns a new dict and
  leaves the one it was given unchanged.

Where the reference's caches fail silently the port raises (ROADMAP queue
3, F2 and F3): a windowed ring cache keeps its ``window`` slots after a
prompt shorter than the window, and a write past a cache's end raises
``ValueError``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .config import WINDOWED_KINDS, ModelConfig

NEG = torch.finfo(torch.float32).min


def _normal_(p: torch.Tensor, g: torch.Generator, scale: float) -> None:
    with torch.no_grad():
        p.normal_(generator=g).mul_(scale)


def _param(*shape, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# Norms, positional encodings
# ---------------------------------------------------------------------------

def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm with a ``(1 + scale)`` gain; statistics in fp32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale)).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, *, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param(d, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(self.scale, x, self.eps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the two halves of the head (not interleaved).
    x: (B, S, H, hd); positions: (S,) or (B, S)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freq                      # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


# ---------------------------------------------------------------------------
# Attention (GQA; full-causal / sliding-window / bidirectional / cross)
# ---------------------------------------------------------------------------

def causal_mask_bias(sq: int, skv: int, *, offset: int = 0, window: int = 0,
                     bidirectional: bool = False, device=None) -> torch.Tensor:
    """Additive (1, Sq, Skv) fp32 mask; ``offset`` is the absolute position
    of query 0 minus that of key 0; ``window`` > 0 slides."""
    qpos = torch.arange(sq, device=device)[:, None] + offset
    kpos = torch.arange(skv, device=device)[None, :]
    ok = (torch.ones((sq, skv), dtype=torch.bool, device=device) if bidirectional
          else kpos <= qpos)
    if window and window > 0:
        ok = ok & (kpos > qpos - window)
    return _bias(ok)[None]


def _bias(ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, 0.0, NEG).float()


def _attend(q, k, v, cfg: ModelConfig, mask_bias) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); mask_bias: (B or 1, Sq,
    Skv). Head h reads kv head h // G (the reference's grouping h = kv·G + g)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)          # (B, KV, G, Sq, hd)
    kt = k.permute(0, 2, 3, 1)[:, :, None]                           # (B, KV, 1, hd, Skv)
    logits = softcap((qg @ kt / math.sqrt(hd)).float(), cfg.attn_softcap)
    logits = logits + mask_bias[:, None, None, :, :]
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = w @ v.permute(0, 2, 1, 3)[:, :, None]                      # (B, KV, G, Sq, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def _proj_in(x, w):
    """x (B, S, d) · w (d, H, hd) → (B, S, H, hd), w cast to x's dtype."""
    d, H, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, H * hd)).reshape(*x.shape[:-1], H, hd)


def _proj_out(o, w):
    """o (B, S, H, hd) · w (H, hd, d) → (B, S, d)."""
    H, hd, d = w.shape
    return o.reshape(*o.shape[:-2], H * hd) @ w.to(o.dtype).reshape(H * hd, d)


class Attention(nn.Module):
    """Self- or cross-attention with the reference's parameters
    (``cross=True``: no QKV bias)."""

    def __init__(self, cfg: ModelConfig, *, cross: bool = False, device=None):
        super().__init__()
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.cfg = cfg
        self.wq = _param(d, H, hd, device=device)
        self.wk = _param(d, KV, hd, device=device)
        self.wv = _param(d, KV, hd, device=device)
        self.wo = _param(H, hd, d, device=device)
        self.has_bias = cfg.qkv_bias and not cross
        if self.has_bias:
            self.bq = _param(H, hd, device=device)
            self.bk = _param(KV, hd, device=device)
            self.bv = _param(KV, hd, device=device)

    def init_(self, g: torch.Generator) -> None:
        cfg = self.cfg
        for w in (self.wq, self.wk, self.wv):
            _normal_(w, g, 1.0 / math.sqrt(cfg.d_model))
        _normal_(self.wo, g, 1.0 / math.sqrt(cfg.n_heads * cfg.head_dim))

    def kv(self, x_kv: torch.Tensor):
        k, v = _proj_in(x_kv, self.wk), _proj_in(x_kv, self.wv)
        if self.has_bias:
            k, v = k + self.bk.to(x_kv.dtype), v + self.bv.to(x_kv.dtype)
        return k, v

    def _q(self, x):
        q = _proj_in(x, self.wq)
        return q + self.bq.to(x.dtype) if self.has_bias else q

    def forward(self, x, positions, *, kind: str, cache=None, cache_pos: int | None = None,
                enc_out=None):
        """Returns (out (B, S, d), new_cache). ``cache`` {"k", "v"}: (B,
        S_cache, KV, hd); ``cache_pos`` is the absolute position of x's
        first token (the number of tokens already cached). A windowed cache
        of ``window`` slots is a ring: position p lives in slot p mod
        window."""
        cfg = self.cfg
        window = cfg.window if kind in WINDOWED_KINDS else 0
        if enc_out is not None:
            # cross attention: no mask, no rope
            k, v = self.kv(enc_out)
            bias = torch.zeros((1, x.shape[1], enc_out.shape[1]), device=x.device)
            return _proj_out(_attend(self._q(x), k, v, cfg, bias), self.wo), None

        q = self._q(x)
        k, v = self.kv(x)
        if cfg.pos_embedding == "rope":
            q, k = rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta)

        new_cache = None
        if cache is None:
            bias = causal_mask_bias(x.shape[1], x.shape[1], window=window,
                                    bidirectional=kind == "enc", device=x.device)
            out = _attend(q, k, v, cfg, bias)
        else:
            S_cache, Sq = cache["k"].shape[1], x.shape[1]
            if window and S_cache == window:
                out, new_cache = self._ring(q, k, v, cache, cache_pos, window)
            else:
                if cache_pos + Sq > S_cache:
                    raise ValueError(f"cache overflow: positions {cache_pos}..{cache_pos + Sq - 1}"
                                     f" do not fit a cache of {S_cache}")
                ck = torch.slice_scatter(cache["k"], k, 1, cache_pos, cache_pos + Sq)
                cv = torch.slice_scatter(cache["v"], v, 1, cache_pos, cache_pos + Sq)
                bias = causal_mask_bias(Sq, S_cache, offset=cache_pos, window=window,
                                        device=x.device)
                out = _attend(q, ck, cv, cfg, bias)
                new_cache = {"k": ck, "v": cv}
        return _proj_out(out, self.wo), new_cache

    def _ring(self, q, k, v, cache, cache_pos, window):
        Sq = q.shape[1]
        dev = q.device
        if Sq == 1:
            # decode: slot i holds the latest position p ≤ cache_pos with
            # p ≡ i (mod window); slots not yet written are masked
            slot = cache_pos % window
            ck = torch.slice_scatter(cache["k"], k, 1, slot, slot + 1)
            cv = torch.slice_scatter(cache["v"], v, 1, slot, slot + 1)
            kabs = cache_pos - torch.remainder(slot - torch.arange(window, device=dev), window)
            out = _attend(q, ck, cv, self.cfg, _bias(kabs >= 0)[None, None, :])
            return out, {"k": ck, "v": cv}
        if cache_pos != 0:
            raise ValueError("a ring cache takes a multi-token input only from an empty "
                             f"cache (cache_pos 0), not at {cache_pos}")
        # prefill: attend directly, then keep the last min(Sq, window)
        # positions at their slots; the ring stays `window` long
        out = _attend(q, k, v, self.cfg, causal_mask_bias(Sq, Sq, window=window, device=dev))
        keep = min(Sq, window)
        slots = torch.arange(Sq - keep, Sq, device=dev) % window
        ck = cache["k"].index_copy(1, slots, k[:, Sq - keep:])
        cv = cache["v"].index_copy(1, slots, v[:, Sq - keep:])
        return out, {"k": ck, "v": cv}

    def cross_cached(self, x, cache):
        """Decode-time cross attention against precomputed encoder K/V."""
        bias = torch.zeros((1, x.shape[1], cache["ck"].shape[1]), device=x.device)
        out = _attend(_proj_in(x, self.wq), cache["ck"], cache["cv"], self.cfg, bias)
        return _proj_out(out, self.wo)


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU or GELU)
# ---------------------------------------------------------------------------

def _gelu(x):
    return F.gelu(x, approximate="tanh")        # jax.nn.gelu's default


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, d_ff: int | None = None, *, device=None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.wi = _param(d, f, device=device)
        self.wo = _param(f, d, device=device)
        self.swiglu = cfg.mlp_act == "swiglu"
        if self.swiglu:
            self.wg = _param(d, f, device=device)

    def init_(self, g: torch.Generator) -> None:
        d, f = self.wi.shape
        _normal_(self.wi, g, 1.0 / math.sqrt(d))
        if self.swiglu:
            _normal_(self.wg, g, 1.0 / math.sqrt(d))
        _normal_(self.wo, g, 1.0 / math.sqrt(f))

    def forward(self, x):
        dt = x.dtype
        h = x @ self.wi.to(dt)
        h = F.silu(x @ self.wg.to(dt)) * h if self.swiglu else _gelu(h)
        return h @ self.wo.to(dt)


# ---------------------------------------------------------------------------
# MoE MLP: group-capacity dispatch through one-hot einsums, group size 512
# ---------------------------------------------------------------------------

MOE_GROUP = 512


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d, E, f = cfg.d_model, cfg.n_experts, cfg.d_expert_eff
        self.cfg = cfg
        self.router = _param(d, E, device=device)
        self.wi = _param(E, d, f, device=device)
        self.wg = _param(E, d, f, device=device)
        self.wo = _param(E, f, d, device=device)
        self.shared = (MLP(cfg, d_ff=cfg.n_shared_experts * f, device=device)
                       if cfg.n_shared_experts else None)

    def init_(self, g: torch.Generator) -> None:
        d, f = self.cfg.d_model, self.cfg.d_expert_eff
        for w in (self.router, self.wi, self.wg):
            _normal_(w, g, 1.0 / math.sqrt(d))
        _normal_(self.wo, g, 1.0 / math.sqrt(f))

    def forward(self, x):
        """Top-k routing with per-group capacity; a token dropped by every
        expert passes through the residual only."""
        cfg = self.cfg
        B, S, D = x.shape
        E, k, dt = cfg.n_experts, cfg.top_k, x.dtype
        g_sz = min(MOE_GROUP, S)
        G = (B * S) // g_sz
        xg = x.reshape(G, g_sz, D)
        C = max(1, int(math.ceil(k * g_sz * cfg.capacity_factor / E)))

        probs = torch.softmax(xg.float() @ self.router, dim=-1)          # (G, T, E)
        gate_vals, gate_idx = torch.topk(probs, k, dim=-1)               # (G, T, k)
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

        # each entry's place in its expert's queue, slot 0 of every token first
        onehot = F.one_hot(gate_idx, E).float()                          # (G, T, k, E)
        flat = onehot.permute(0, 2, 1, 3).reshape(G, k * g_sz, E)
        pos = torch.cumsum(flat, dim=1) - flat
        pos = pos.reshape(G, k, g_sz, E).permute(0, 2, 1, 3)             # (G, T, k, E)
        in_cap = (pos < C).float() * onehot
        pos_cap = torch.clamp((pos * onehot).sum(-1), 0, C - 1).long()   # (G, T, k)
        slot_oh = F.one_hot(pos_cap, C).float()                          # (G, T, k, C)

        dispatch = torch.einsum("gtke,gtkc->gtec", in_cap, slot_oh)
        combine = torch.einsum("gtke,gtkc,gtk->gtec", in_cap, slot_oh, gate_vals)
        xe = torch.einsum("gtec,gtd->gecd", dispatch.to(dt), xg)
        h = torch.einsum("gecd,edf->gecf", xe, self.wi.to(dt))
        hg = torch.einsum("gecd,edf->gecf", xe, self.wg.to(dt))
        ye = torch.einsum("gecf,efd->gecd", F.silu(hg) * h, self.wo.to(dt))
        y = torch.einsum("gecd,gtec->gtd", ye, combine.to(dt)).reshape(B, S, D)
        if self.shared is not None:
            y = y + self.shared(x)
        return y


# ---------------------------------------------------------------------------
# Griffin / RecurrentGemma RG-LRU block; cache {"h": (B, W) fp32,
# "conv": (B, conv_width - 1, W)}
# ---------------------------------------------------------------------------

RG_LRU_HEADS = 16   # block-diagonal gate matrices
RG_LRU_C = 8.0


class RGLRUBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d, w = cfg.d_model, cfg.rnn_width_eff
        nh = RG_LRU_HEADS if w % RG_LRU_HEADS == 0 else 1
        self.cfg = cfg
        self.wx = _param(d, w, device=device)
        self.wgate = _param(d, w, device=device)
        self.conv = _param(cfg.conv_width, w, device=device)
        self.w_in_gate = _param(nh, w // nh, w // nh, device=device)
        self.w_a_gate = _param(nh, w // nh, w // nh, device=device)
        self.a_param = _param(w, device=device)
        self.wo = _param(w, d, device=device)

    def init_(self, g: torch.Generator) -> None:
        d = self.cfg.d_model
        w, wh = self.a_param.shape[0], self.w_in_gate.shape[1]
        _normal_(self.wx, g, 1.0 / math.sqrt(d))
        _normal_(self.wgate, g, 1.0 / math.sqrt(d))
        _normal_(self.conv, g, 1.0 / math.sqrt(self.cfg.conv_width))
        _normal_(self.w_in_gate, g, 1.0 / math.sqrt(wh))
        _normal_(self.w_a_gate, g, 1.0 / math.sqrt(wh))
        _normal_(self.wo, g, 1.0 / math.sqrt(w))
        with torch.no_grad():
            # decay a ≈ 0.9-0.999 (Griffin): a_param = softplus⁻¹(−log λ / c)
            lam = torch.empty_like(self.a_param).uniform_(0.9, 0.999, generator=g)
            self.a_param.copy_(torch.log(torch.expm1(-torch.log(lam) / RG_LRU_C)))

    @staticmethod
    def _gate(wg, u):
        """sigmoid(u @ blockdiag(wg)), wg (nh, wh, wh)."""
        B, S, W = u.shape
        nh, wh, _ = wg.shape
        uh = u.reshape(B, S, nh, wh).transpose(1, 2)                    # (B, nh, S, wh)
        return torch.sigmoid((uh @ wg.to(u.dtype)).transpose(1, 2).reshape(B, S, W))

    def _rg_lru(self, u, h0):
        """h_t = a_t·h_{t−1} + b_t over the sequence, in fp32, by a loop
        over time (the reference's associative scan in another order)."""
        r_gate = self._gate(self.w_a_gate, u)
        i_gate = self._gate(self.w_in_gate, u)
        log_a = -RG_LRU_C * F.softplus(self.a_param) * r_gate.float()
        a = torch.exp(log_a)
        b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (u * i_gate).float()
        h, ys = h0.float(), []
        for t in range(u.shape[1]):
            h = a[:, t] * h + b[:, t]
            ys.append(h)
        y = torch.stack(ys, dim=1)
        return y.to(u.dtype), h

    def forward(self, x, cache=None):
        dt = x.dtype
        B, S, _ = x.shape
        cw = self.cfg.conv_width
        u = x @ self.wx.to(dt)
        gate = _gelu(x @ self.wgate.to(dt))
        if cache is not None:
            hist = torch.cat([cache["conv"].to(dt), u], dim=1)
            h0 = cache["h"]
        else:
            hist = F.pad(u, (0, 0, cw - 1, 0))
            h0 = torch.zeros((B, u.shape[-1]), device=x.device)
        conv = hist[:, 0:S] * self.conv[0].to(dt)
        for i in range(1, cw):
            conv = conv + hist[:, i:i + S] * self.conv[i].to(dt)
        y, h_T = self._rg_lru(conv, h0)
        out = (y * gate) @ self.wo.to(dt)
        if cache is None:
            return out, None
        return out, {"h": h_T, "conv": hist[:, -(cw - 1):].to(cache["conv"].dtype)}


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): time mix with data-dependent decay, then channel mix;
# cache {"S": (B, H, hd, hd) fp32, "tm_x": (B, D), "cm_x": (B, D)}
# ---------------------------------------------------------------------------

class RWKVBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d, r, f = cfg.d_model, cfg.rwkv_lora_r, cfg.d_ff
        H, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
        self.cfg = cfg
        for name in ("wr", "wk", "wv", "wg", "wo_tm", "cm_wr"):
            setattr(self, name, _param(d, d, device=device))
        self.mu = _param(5, d, device=device)                 # streams r, k, v, g, w
        self.mu_lora_a = _param(d, r, device=device)
        self.mu_lora_b = _param(r, 5, d, device=device)
        self.w0 = _param(d, device=device)
        self.w_lora_a = _param(d, r, device=device)
        self.w_lora_b = _param(r, d, device=device)
        self.u = _param(H, hd, device=device)
        self.ln_x = RMSNorm(d, cfg.norm_eps, device=device)
        self.cm_mu = _param(2, d, device=device)
        self.cm_wk = _param(d, f, device=device)
        self.cm_wv = _param(f, d, device=device)

    def init_(self, g: torch.Generator) -> None:
        d, r, f = self.cfg.d_model, self.cfg.rwkv_lora_r, self.cfg.d_ff
        for w in (self.wr, self.wk, self.wv, self.wg, self.wo_tm, self.mu_lora_a,
                  self.w_lora_a, self.cm_wk, self.cm_wr):
            _normal_(w, g, 1.0 / math.sqrt(d))
        for w in (self.mu_lora_b, self.w_lora_b):
            _normal_(w, g, 1.0 / math.sqrt(r))
        _normal_(self.u, g, 0.1)
        _normal_(self.cm_wv, g, 1.0 / math.sqrt(f))
        with torch.no_grad():
            self.mu.uniform_(0.0, 1.0, generator=g)
            self.cm_mu.uniform_(0.0, 1.0, generator=g)
            self.w0.fill_(-6.0)

    @staticmethod
    def _shift(x, first):
        """The previous token of each position: ``first`` (B, D) before the
        sequence (zeros without a cache)."""
        if first is None:
            return F.pad(x, (0, 0, 1, 0))[:, :-1]
        return torch.cat([first.to(x.dtype)[:, None], x[:, :-1]], dim=1)

    @staticmethod
    def _wkv(r, k, v, w, u, S):
        """S_t = diag(w_t)·S_{t−1} + k_t v_tᵀ;  y_t = S_{t−1}ᵀ r_t + (rᵀ(u⊙k)) v,
        all (B, T, H, hd) in fp32, sequentially over time."""
        ys = []
        for t in range(r.shape[1]):
            r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]
            y = torch.einsum("bhij,bhi->bhj", S, r_t) + (
                (r_t * u[None] * k_t).sum(-1, keepdim=True) * v_t)
            S = w_t[..., None] * S + k_t[..., :, None] * v_t[..., None, :]
            ys.append(y)
        return torch.stack(ys, dim=1), S

    def forward(self, x_raw, ln1: RMSNorm, ln2: RMSNorm, cache=None):
        """The whole layer (the norms come from the layer: token shift
        runs on the normed stream). Returns (x_new, new_cache)."""
        cfg = self.cfg
        dt = x_raw.dtype
        B, T, D = x_raw.shape
        H, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim

        # ---- time mix ----
        x = ln1(x_raw)
        dx = self._shift(x, None if cache is None else cache["tm_x"]) - x
        lora = (x + dx * self.mu[4].to(dt)) @ self.mu_lora_a.to(dt)
        mix = self.mu.to(dt)[None, None] + torch.einsum(
            "btr,rsd->btsd", torch.tanh(lora), self.mu_lora_b.to(dt))     # (B, T, 5, D)
        xr, xk, xv, xg, xw = (x + dx * mix[:, :, i] for i in range(5))
        r = (xr @ self.wr.to(dt)).reshape(B, T, H, hd)
        k = (xk @ self.wk.to(dt)).reshape(B, T, H, hd)
        v = (xv @ self.wv.to(dt)).reshape(B, T, H, hd)
        g = F.silu(xg @ self.wg.to(dt))
        wlog = self.w0 + torch.tanh(xw @ self.w_lora_a.to(dt)).float() @ self.w_lora_b
        w = torch.exp(-torch.exp(wlog)).reshape(B, T, H, hd)
        S0 = (cache["S"] if cache is not None
              else torch.zeros((B, H, hd, hd), device=x_raw.device))
        y, S_T = self._wkv(r.float(), k.float(), v.float(), w, self.u, S0)
        y = self.ln_x(y.reshape(B, T, D).to(dt))
        x_mid = x_raw + (y * g) @ self.wo_tm.to(dt)

        # ---- channel mix ----
        x2 = ln2(x_mid)
        dx2 = self._shift(x2, None if cache is None else cache["cm_x"]) - x2
        xk2 = x2 + dx2 * self.cm_mu[0].to(dt)
        xr2 = x2 + dx2 * self.cm_mu[1].to(dt)
        kk = torch.square(torch.relu(xk2 @ self.cm_wk.to(dt)))
        out = x_mid + torch.sigmoid(xr2 @ self.cm_wr.to(dt)) * (kk @ self.cm_wv.to(dt))
        if cache is None:
            return out, None
        return out, {"S": S_T, "tm_x": x[:, -1].to(cache["tm_x"].dtype),
                     "cm_x": x2[:, -1].to(cache["cm_x"].dtype)}

"""Plain reference of a dense GQA decoder, in float32 PyTorch.

The published architecture written out with nothing of the program: token
embedding; per layer x + Attn(RMSNorm(x)), then x + MLP(RMSNorm(x)), with
RMSNorm y = x / sqrt(mean(x^2) + eps) * (1 + w), rotary embeddings on the
two halves of each head (angles in float64), causal softmax attention in
which query head h reads key/value head h // (H / Kv), and the gated MLP
W_down(silu(x W_gate) * (x W_up)); a final RMSNorm and the output head
(the embedding's transpose where the head is tied).  No cache: one full
forward over the whole sequence, layer by layer, with the attention taken
in blocks of query rows so that it fits.  TF32 is off.

``precision="fp8"`` is the control: every product's two operands are
rounded to float8 e4m3 (a scale per row of the left operand, one per right
operand) before a float32 product; norms, rotary and softmax stay float32.
"""
from __future__ import annotations

import math

import torch

QUERY_BLOCK = 1024
FP8_MAX = 448.0  # largest finite float8 e4m3


def _fp8(x: torch.Tensor, dim) -> torch.Tensor:
    """x rounded to float8 e4m3 under a scale per slice along ``dim``
    (None: one scale), back in float32."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim, keepdim=True)
    scale = amax.clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Products:
    """The products of one forward in float32 or, for the control, on
    float8-rounded operands."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.low = precision == "fp8"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a (..., K) @ b (K, N)."""
        if self.low:
            a, b = _fp8(a, -1), _fp8(b, None)
        return a @ b

    def operand(self, x: torch.Tensor, dim) -> torch.Tensor:
        return _fp8(x, dim) if self.low else x


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * \
        (1.0 + w.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, hd) at positions 0..T-1."""
    T, _, hd = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                         device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, pr: Products) -> torch.Tensor:
    """Causal GQA attention: q (T, H, hd), k and v (T, Kv, hd)."""
    T, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    qo, ko, vo = pr.operand(q, -1), pr.operand(k, -1), pr.operand(v, None)
    out = torch.empty_like(q)
    for q0 in range(0, T, QUERY_BLOCK):
        q1 = min(T, q0 + QUERY_BLOCK)
        s = torch.einsum("qhd,khd->hqk", qo[q0:q1], ko[:q1]) / math.sqrt(hd)
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        cols = torch.arange(q1, device=q.device)[None, :]
        s.masked_fill_(cols > rows, float("-inf"))
        p = pr.operand(torch.softmax(s, dim=-1), -1)
        out[q0:q1] = torch.einsum("hqk,khd->qhd", p, vo[:q1])
    return out


def logits(w: dict, c: dict, tokens: torch.Tensor, start: int,
           precision: str = "fp32") -> torch.Tensor:
    """(T - start, vocab_size) float32 logits of positions start..T-1 of
    ``tokens`` (T,), each predicting the token after it.  ``w`` holds the
    weights as made (``families/dense.py``), read here in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pr = Products(precision)
    eps, theta = float(c["rms_norm_eps"]), float(c["rope_theta"])
    H, Kv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"])
    T = tokens.shape[0]
    x = w["embed"][tokens].float()
    for i in range(c["num_hidden_layers"]):
        h = rms_norm(x, w["ln1"][i], eps)
        q = pr.mm(h, w["wq"][i].float().reshape(h.shape[-1], H * hd))
        k = pr.mm(h, w["wk"][i].float().reshape(h.shape[-1], Kv * hd))
        v = pr.mm(h, w["wv"][i].float().reshape(h.shape[-1], Kv * hd))
        q = rope(q.reshape(T, H, hd), theta)
        k = rope(k.reshape(T, Kv, hd), theta)
        a = attention(q, k, v.reshape(T, Kv, hd), pr)
        x = x + pr.mm(a.reshape(T, H * hd), w["wo"][i].float().reshape(
            H * hd, -1))
        h = rms_norm(x, w["ln2"][i], eps)
        g = torch.nn.functional.silu(pr.mm(h, w["w_gate"][i].float()))
        x = x + pr.mm(g * pr.mm(h, w["w_up"][i].float()),
                      w["w_down"][i].float())
    h = rms_norm(x[start:], w["final_norm"], eps)
    head = w["embed"].T if c["tie_word_embeddings"] else w["head"]
    return pr.mm(h, head.float())[:, :c["vocab_size"]]

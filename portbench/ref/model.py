"""Plain PyTorch reference of the lip reader: the patchify and conv3d stems,
the pre-LN transformer encoder, the CTC head and the teacher-forced
transformer decoder, in float32 (TF32 off), over a flat dict of parameter
tensors keyed as the release checkpoints key them ("frontend.embed.w").

It follows the release's architecture as its config describes it: dense
weights are [in, out], convolutions [kT, kH, kW, Cin, Cout] with XLA's SAME
padding (the extra pad after), GroupNorm over gcd(8, C) groups per sample
(or per frame with ``framewise_norm``), LayerNorm eps 1e-5, GELU (tanh),
sinusoidal ``pos`` tables as parameters, key masks at -1e30. No kernel, no
cache, no batching trick.

``Prec`` sets the arithmetic: "fp32" is the reference; "fp8" rounds both
operands of every dense layer and convolution to float8 e4m3 with a scale
per tensor (the control one precision step below the releases' bfloat16);
"tf32" leaves TF32 on for matmuls and convolutions (the control one step
below float32)."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

NEG = -1e30
FP8_MAX = 448.0


class Prec:
    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8", "tf32"):
            raise ValueError(f"precision {kind!r}")
        self.kind = kind

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """An operand as this precision holds it (straight through in the
        backward)."""
        if self.kind != "fp8":
            return t
        s = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        r = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
        return t + (r - t.detach())

    @contextlib.contextmanager
    def flags(self):
        """TF32 on only for "tf32"; the caller's settings come back."""
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        on = self.kind == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev


def dense(P, name, x, prec):
    y = prec.q(x) @ prec.q(P[f"{name}.w"])
    b = P.get(f"{name}.b")
    return y if b is None else y + b


def layernorm(P, name, x):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5) * P[f"{name}.scale"] \
        + P[f"{name}.bias"]


def groupnorm(P, name, x, framewise):
    """x [B, T, ..., C]: statistics over each group's channels and every
    other axis but the batch (and time when ``framewise``)."""
    C = x.shape[-1]
    g = math.gcd(8, C)
    lead = 2 if framewise else 1
    xs = x.reshape(*x.shape[:lead], -1, g, C // g)
    dims = (lead, lead + 2)
    mean = xs.mean(dims, keepdim=True)
    var = ((xs - mean) ** 2).mean(dims, keepdim=True)
    y = ((xs - mean) / torch.sqrt(var + 1e-5)).reshape(x.shape)
    return y * P[f"{name}.scale"] + P[f"{name}.bias"]


def _same(size, k, s):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv3d(P, name, x, prec, strides=(1, 1, 1)):
    """x [B, T, H, W, Cin] -> [B, T', H', W', Cout], SAME padding."""
    w = P[f"{name}.w"]
    pads = []
    for axis in (3, 2, 1):
        pads.extend(_same(x.shape[axis], w.shape[axis - 1], strides[axis - 1]))
    xc = F.pad(prec.q(x).permute(0, 4, 1, 2, 3), pads)
    y = F.conv3d(xc, prec.q(w).permute(4, 3, 0, 1, 2), stride=strides)
    return y.permute(0, 2, 3, 4, 1) + P[f"{name}.b"]


def maxpool(x):
    """(1, 2, 2) max pool of [B, T, H, W, C], VALID."""
    B, T, H, W, C = x.shape
    x = x[:, :, :H - H % 2, :W - W % 2]
    return x.reshape(B, T, H // 2, 2, W // 2, 2, C).amax(dim=(3, 5))


def highways(P, x, m, prec):
    for i in range(m["highway_layers"]):
        n = f"frontend.highway.{i}"
        t = torch.sigmoid(dense(P, f"{n}.t", x, prec))
        x = torch.relu(dense(P, f"{n}.h", x, prec)) * t + x * (1.0 - t)
    return x


def patchify(P, m, rois, prec):
    B, T, R, _ = rois.shape
    ps = m["patch_size"]
    g = R // ps
    fw = m.get("framewise_norm", False)
    x = rois.reshape(B, T, g, ps, g, ps).permute(0, 1, 2, 4, 3, 5)
    x = x.reshape(B, T, g, g, ps * ps)
    z = torch.zeros_like(x[:, :1])
    x = torch.cat([torch.cat([z, x[:, :-1]], 1), x,
                   torch.cat([x[:, 1:], z], 1)], -1)
    x = maxpool(torch.relu(groupnorm(P, "frontend.gn_e",
                                     dense(P, "frontend.embed", x, prec), fw)))
    x = maxpool(torch.relu(groupnorm(P, "frontend.gnA",
                                     conv3d(P, "frontend.convA", x, prec), fw)))
    x = torch.relu(groupnorm(P, "frontend.gnB",
                             conv3d(P, "frontend.convB", x, prec), fw))
    return highways(P, dense(P, "frontend.proj", x.reshape(B, T, -1), prec),
                    m, prec)


def conv3d_stem(P, m, rois, prec):
    fw = m.get("framewise_norm", False)
    x = rois[..., None]
    x = maxpool(torch.relu(groupnorm(
        P, "frontend.gn0", conv3d(P, "frontend.conv0", x, prec, (1, 2, 2)),
        fw)))
    x = maxpool(torch.relu(groupnorm(
        P, "frontend.gn1", conv3d(P, "frontend.conv1", x, prec), fw)))
    x = maxpool(torch.relu(groupnorm(
        P, "frontend.gn2", conv3d(P, "frontend.conv2", x, prec), fw)))
    B, T = x.shape[:2]
    return highways(P, dense(P, "frontend.proj", x.reshape(B, T, -1), prec),
                    m, prec)


def attention(P, name, q_in, kv_in, mask, heads, prec):
    """mask [B, 1, Tq or 1, Tk] bool, True where a key is attended."""
    B, Tq, D = q_in.shape
    Tk = kv_in.shape[1]
    dh = D // heads
    q = dense(P, f"{name}.q", q_in, prec).reshape(B, Tq, heads, dh)
    k = dense(P, f"{name}.k", kv_in, prec).reshape(B, Tk, heads, dh)
    v = dense(P, f"{name}.v", kv_in, prec).reshape(B, Tk, heads, dh)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    w = torch.softmax(torch.where(mask, s, NEG), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, Tq, D)
    return dense(P, f"{name}.o", out, prec)


def mlp(P, name, x, prec):
    h = F.gelu(dense(P, f"{name}.in", x, prec), approximate="tanh")
    return dense(P, f"{name}.out", h, prec)


def key_mask(lengths, T):
    return (torch.arange(T, device=lengths.device)[None, :]
            < lengths[:, None])[:, None, None, :]


def _keep(x):
    return x


def encode(P, cfg, rois, lengths, prec, drop=_keep):
    """[B, T, R, R] normalised ROIs + [B] lengths -> [B, T, tf_dim];
    ``drop`` (dropout) on the stem's output and on each residual branch."""
    m = cfg["model"]
    stem = patchify if m.get("frontend") == "patchify" else conv3d_stem
    x = drop(stem(P, m, rois, prec))
    T = x.shape[1]
    h = dense(P, "encoder.proj", x, prec) + P["encoder.pos"][:T]
    mask = key_mask(lengths, T)
    for i in range(m["tf_layers"]):
        n = f"encoder.layers.{i}"
        hn = layernorm(P, f"{n}.ln1", h)
        h = h + drop(attention(P, f"{n}.attn", hn, hn, mask, m["tf_heads"],
                               prec))
        h = h + drop(mlp(P, f"{n}.mlp", layernorm(P, f"{n}.ln2", h), prec))
    return layernorm(P, "encoder.ln_out", h)


def ctc_log_probs(P, enc, prec):
    return torch.log_softmax(dense(P, "ctc_head", enc, prec), dim=-1)


def decoder_log_probs(P, cfg, tokens, enc, enc_lengths, prec, drop=_keep):
    """Teacher-forced decoder: tokens [B, L] (sos first) -> [B, L, V]
    next-token log-probabilities; ``drop`` (dropout) on each residual
    branch."""
    m = cfg["model"]
    B, L = tokens.shape
    D = enc.shape[-1]
    h = F.embedding(tokens.long(), P["att_decoder.embed.table"]) \
        * math.sqrt(D) + P["att_decoder.pos"][:L]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=h.device))[None, None]
    emask = key_mask(enc_lengths, enc.shape[1])
    for i in range(m["tf_dec_layers"]):
        n = f"att_decoder.layers.{i}"
        hn = layernorm(P, f"{n}.ln1", h)
        h = h + drop(attention(P, f"{n}.self", hn, hn, causal,
                               m["tf_heads"], prec))
        h = h + drop(attention(P, f"{n}.cross", layernorm(P, f"{n}.ln2", h),
                               enc, emask, m["tf_heads"], prec))
        h = h + drop(mlp(P, f"{n}.mlp", layernorm(P, f"{n}.ln3", h), prec))
    h = layernorm(P, "att_decoder.ln_out", h)
    return torch.log_softmax(dense(P, "att_decoder.out", h, prec), dim=-1)

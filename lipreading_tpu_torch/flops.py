"""Analytic FLOP counts and MFU (counterpart of ``lipreading_tpu/flops.py``).

Counts multiply-accumulate work (2 FLOPs per MAC) of every matrix product
and convolution of the model, for every family (either stem, the
transformer or bi-GRU encoder, the CTC head and either attention decoder;
the port's Auto-AVSR family: the ResNet-18 trunk on crops of the edge
the caller passes, ``roi_size`` by default, and the Conformer encoder, its depthwise convolutions and relative
positions included); elementwise, normalisation, pooling and softmax work
is left out, as in the JAX package. ``train_step_flops`` is 3x the
forward (the Conformer's projection of the relative positions counted once
a batch, as it runs).

``device_peak_flops`` is NVIDIA's published dense peak of the current card
for the compute type: the H100 SXM (989 TFLOP/s bf16, 67 TFLOP/s float32
outside the tensor cores) and the H100 PCIe (756 and 51); any other card,
or no card, gives None, and then no MFU is logged. ``card_peaks`` gives a
named card's memory rate beside its float32 peak (3.35 TB/s for the SXM's
HBM3, 2.0 TB/s for the PCIe's HBM2e), for the preprocess roofline.
"""

from __future__ import annotations

import math

from lipreading_tpu_torch.config import Config, PreprocessConfig
from lipreading_tpu_torch.models.conformer import CONV_KERNEL
from lipreading_tpu_torch.models.resnet import STRIDES, WIDTHS

# dense peak FLOP/s by the product in torch.cuda.get_device_name() and dtype
_PEAKS = {
    "H100 SXM": {"bfloat16": 989e12, "float32": 67e12},
    "H100 PCIe": {"bfloat16": 756e12, "float32": 51e12},
}
# memory rate in bytes/s by the same product
_BYTES_PER_S = {"H100 SXM": 3.35e12, "H100 PCIe": 2.0e12}


def _product(name: str) -> str | None:
    """The key of _PEAKS for a card's name: "NVIDIA H100 80GB HBM3" is the
    SXM part, "NVIDIA H100 PCIe" the PCIe part."""
    if "H100" not in name:
        return None
    if "PCIe" in name:
        return "H100 PCIe"
    if "SXM" in name or "HBM3" in name:
        return "H100 SXM"
    return None


def device_peak_flops(dtype: str = "bfloat16") -> float | None:
    """Dense peak FLOP/s of CUDA device 0 for ``dtype``, or None."""
    import torch

    if not torch.cuda.is_available():
        return None
    key = _product(torch.cuda.get_device_name(0))
    if key is None:
        return None
    return _PEAKS[key].get(dtype, _PEAKS[key]["bfloat16"])


def card_peaks(name: str) -> dict | None:
    """{"bytes": bytes/s, "float32": FLOP/s} of the card that
    ``torch.cuda.get_device_name`` calls ``name``, or None for any other
    card (or "cpu")."""
    key = _product(name)
    if key is None:
        return None
    return {"bytes": _BYTES_PER_S[key], "float32": _PEAKS[key]["float32"]}


def _dense(n: int, din: int, dout: int) -> float:
    return 2.0 * n * din * dout


def conv3d_flops(t: int, h: int, w: int, kernel, cin: int, cout: int,
                 strides=(1, 1, 1)) -> float:
    to = -(-t // strides[0])
    ho = -(-h // strides[1])
    wo = -(-w // strides[2])
    return 2.0 * to * ho * wo * math.prod(kernel) * cin * cout


def frontend_flops(cfg: Config, T: int) -> float:
    """Per-sample forward FLOPs of the visual stem over T frames."""
    m = cfg.model
    R = cfg.preprocess.roi_size                       # 96
    if m.frontend == "patchify":
        P, ps = m.patch_dim, m.patch_size
        g = R // ps                                    # 12
        f = _dense(T * g * g, 3 * ps * ps, P)          # tubelet embed
        f += conv3d_flops(T, g // 2, g // 2, (3, 3, 3), P, P)     # 6x6
        f += conv3d_flops(T, g // 4, g // 4, (3, 3, 3), P, P)     # 3x3
        f += _dense(T, P * (g // 4) ** 2, m.frontend_dim)
    else:
        c0, c1, c2 = m.frontend_channels
        f = conv3d_flops(T, R, R, (3, 5, 5), 1, c0, (1, 2, 2))    # -> 48
        f += conv3d_flops(T, R // 4, R // 4, (3, 5, 5), c0, c1)   # 24
        f += conv3d_flops(T, R // 8, R // 8, (3, 3, 3), c1, c2)   # 12
        f += _dense(T, c2 * 6 * 6, m.frontend_dim)
    f += m.highway_layers * 2 * _dense(T, m.frontend_dim, m.frontend_dim)
    return f


def resnet18_flops(cfg: Config, T: int, crop: int | None = None) -> float:
    """Per-sample forward FLOPs of the ResNet-18 trunk over T frames of
    ``crop`` (default ``roi_size``) pixels a side."""
    C = crop or cfg.preprocess.roi_size
    f = conv3d_flops(T, C, C, (5, 7, 7), 1, WIDTHS[0], (1, 2, 2))
    s = -(-(-(-C // 2)) // 2)          # ceil(ceil(C / 2) / 2): conv0, pool
    cin = WIDTHS[0]
    for cout, stride in zip(WIDTHS, STRIDES):
        so = -(-s // stride)
        f += conv3d_flops(T, so, so, (1, 3, 3), cin, cout)
        f += 3 * conv3d_flops(T, so, so, (1, 3, 3), cout, cout)
        if stride != 1 or cin != cout:
            f += conv3d_flops(T, so, so, (1, 1, 1), cin, cout)
        s, cin = so, cout
    return f


def conformer_encoder_flops(cfg: Config, T: int) -> float:
    """Per-sample forward FLOPs of the Conformer encoder: the input
    projection, and in each block two FFNs, the q, k, v and output
    projections, the content and position scores (T x T and T x (2T-1)),
    the weighted sum and the convolution module; the positions' own
    projection (once a batch) is ``relpos_flops``."""
    m = cfg.model
    D, M, K = m.tf_dim, m.tf_mlp, CONV_KERNEL
    per_block = (
        2 * (_dense(T, D, M) + _dense(T, M, D))
        + 4 * _dense(T, D, D)
        + 2.0 * T * T * D + 2.0 * T * (2 * T - 1) * D + 2.0 * T * T * D
        + _dense(T, D, 2 * D) + 2.0 * T * D * K + _dense(T, D, D)
    )
    return m.tf_layers * per_block + _dense(T, WIDTHS[-1], D)


def relpos_flops(cfg: Config, T: int) -> float:
    """The Conformer blocks' projections of the 2T-1 relative positions,
    computed once a batch."""
    m = cfg.model
    return m.tf_layers * _dense(2 * T - 1, m.tf_dim, m.tf_dim)


def bigru_flops(cfg: Config, T: int) -> float:
    """Both directions of every bi-GRU layer: the input projection and the
    recurrence."""
    m = cfg.model
    H = m.gru_hidden
    f = 0.0
    d = m.frontend_dim
    for _ in range(m.gru_layers):
        f += 2 * (_dense(T, d, 3 * H) + _dense(T, H, 3 * H))
        d = 2 * H
    return f


def transformer_encoder_flops(cfg: Config, T: int) -> float:
    m = cfg.model
    D, M = m.tf_dim, m.tf_mlp
    per_layer = (
        4 * _dense(T, D, D)          # q, k, v, out projections
        + 2 * (2.0 * T * T * D)      # scores + attn @ v
        + _dense(T, D, M) + _dense(T, M, D)
    )
    return m.tf_layers * per_layer + _dense(T, m.frontend_dim, D)


def transformer_decoder_flops(cfg: Config, T: int, L: int) -> float:
    m = cfg.model
    D, M = m.tf_dim, m.tf_mlp
    per_layer = (
        4 * _dense(L, D, D) + 2 * (2.0 * L * L * D)        # self-attn
        + 2 * _dense(L, D, D)                              # cross k, v proj
        + 2 * (2.0 * L * T * D)                            # cross scores+v
        + 2 * _dense(L, D, D)                              # cross q, out
        + _dense(L, D, M) + _dense(L, M, D)
    )
    return m.tf_dec_layers * per_layer + _dense(L, D, m.vocab_size)


def attn_gru_decoder_flops(cfg: Config, T: int, L: int) -> float:
    """The Bahdanau GRU decoder, teacher-forced over L steps."""
    m = cfg.model
    H, A, V = m.decoder_hidden, m.attn_dim, m.vocab_size
    enc = 2 * m.gru_hidden
    f = _dense(T, enc, A)                                  # enc projection
    per_step = (
        _dense(1, H, A) + _dense(T, A, 1) + 2.0 * T * enc  # attend + ctx
        + _dense(1, H + enc, 3 * H) + _dense(1, H, 3 * H)  # gru cell
        + _dense(1, H + enc, V)
    )
    return f + L * per_step


def ctc_head_flops(cfg: Config, T: int) -> float:
    m = cfg.model
    enc = 2 * m.gru_hidden if cfg.encoder == "bigru" else m.tf_dim
    return _dense(T, enc, m.vocab_size)


def model_fwd_flops(cfg: Config, T: int, L: int,
                    crop: int | None = None) -> float:
    """Per-sample forward FLOPs of the configured model, loss heads
    included; ``crop`` is the ROI edge the ResNet-18 trunk reads (the other
    stems read ``roi_size``)."""
    if cfg.model.frontend == "resnet18":
        f = resnet18_flops(cfg, T, crop)
    else:
        f = frontend_flops(cfg, T)
    if cfg.encoder == "bigru":
        f += bigru_flops(cfg, T)
    elif cfg.encoder == "conformer":
        f += conformer_encoder_flops(cfg, T)
    else:
        f += transformer_encoder_flops(cfg, T)
    if cfg.decoder in ("ctc", "hybrid"):
        f += ctc_head_flops(cfg, T)
    if cfg.decoder in ("attention", "hybrid"):
        if cfg.encoder == "bigru":
            f += attn_gru_decoder_flops(cfg, T, L)
        else:
            f += transformer_decoder_flops(cfg, T, L)
    return f


def train_step_flops(cfg: Config, B: int, T: int, L: int,
                     crop: int | None = None) -> float:
    """fwd + bwd ~= 3x fwd (the standard dense-training rule)."""
    once = relpos_flops(cfg, T) if cfg.encoder == "conformer" else 0.0
    return 3.0 * (B * model_fwd_flops(cfg, T, L, crop) + once)


def preprocess_flops(pre: PreprocessConfig, H: int, W: int) -> float:
    """Per-frame forward FLOPs of detect + ERT + fused ROI.

    Counts the matmul work as the JAX package implements it on the TPU: its
    ERT gathers each stage's P pixels by one-hot matmuls over the face crop
    (64x64 sample grid), more FLOPs than the scalar tree walk on purpose.
    The port's ERT takes the pixels by index (``ops/ert.py``) and does not
    do those one-hot FLOPs; the count stays the JAX one, so the two
    packages' preprocess MFU share a numerator."""
    D = 64                                  # detector input
    # resize to 64 as two matmuls, then conv trunk (channels 8, 16, 32)
    f = 2.0 * D * H * W + 2.0 * D * W * D
    f += 2.0 * 32 * 32 * 9 * 1 * 8 + 2.0 * 16 * 16 * 9 * 8 * 16 \
        + 2.0 * 8 * 8 * 9 * 16 * 32 + 2.0 * 8 * 8 * 32 * 4
    # ERT cascade: per stage, P pixel gathers via one-hot matmuls over the
    # face crop (64x64 sample grid) + K trees x leaf one-hot matmul [NL,136]
    S, P = pre.ert_cascades, pre.ert_pool
    K, depth = pre.ert_trees, pre.ert_depth
    NL = 2 ** depth
    f += S * (2.0 * P * 64 * 64 + K * 2.0 * NL * 136)
    # fused ROI: crop+resize as two matmuls [R,H]@[H,W] then [R,W]@[W,R]
    R = pre.roi_size
    f += 2.0 * R * H * W + 2.0 * R * W * R
    return f


def mfu(flops_per_sec: float, dtype: str = "bfloat16") -> float | None:
    peak = device_peak_flops(dtype)
    return None if peak is None else flops_per_sec / peak

"""Frozen copies of the program's FLOP counts and card peaks
(``lipreading_tpu_torch/flops.py``: ``card_peaks``, the per-family forward
counts, ``model_fwd_flops`` and ``train_step_flops``), taking the
configuration as a dict; ``tests/test_portbench_frozen.py`` holds them
equal to the program's. Matrix products and convolutions count 2 FLOPs a
multiply-add; elementwise, normalisation and softmax work is left out.

Added here: ``bf16_peak``, ``preprocess_flops_conv`` (the serving path's
tracked preprocessing with the conv landmarker, per frame: the program's
``preprocess_flops`` counts the ERT's one-hot products instead, which this
path does not run) and ``serve_batch_flops``."""

from __future__ import annotations

import math

import numpy as np

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


def frontend_flops(cfg: dict, T: int) -> float:
    """Per-sample forward FLOPs of the visual stem over T frames."""
    m = cfg["model"]
    R = cfg["preprocess"]["roi_size"]                       # 96
    if m["frontend"] == "patchify":
        P, ps = m["patch_dim"], m["patch_size"]
        g = R // ps                                    # 12
        f = _dense(T * g * g, 3 * ps * ps, P)          # tubelet embed
        f += conv3d_flops(T, g // 2, g // 2, (3, 3, 3), P, P)     # 6x6
        f += conv3d_flops(T, g // 4, g // 4, (3, 3, 3), P, P)     # 3x3
        f += _dense(T, P * (g // 4) ** 2, m["frontend_dim"])
    else:
        c0, c1, c2 = m["frontend_channels"]
        f = conv3d_flops(T, R, R, (3, 5, 5), 1, c0, (1, 2, 2))    # -> 48
        f += conv3d_flops(T, R // 4, R // 4, (3, 5, 5), c0, c1)   # 24
        f += conv3d_flops(T, R // 8, R // 8, (3, 3, 3), c1, c2)   # 12
        f += _dense(T, c2 * 6 * 6, m["frontend_dim"])
    f += m["highway_layers"] * 2 * _dense(T, m["frontend_dim"], m["frontend_dim"])
    return f


def bigru_flops(cfg: dict, T: int) -> float:
    """Both directions of every bi-GRU layer: the input projection and the
    recurrence."""
    m = cfg["model"]
    H = m["gru_hidden"]
    f = 0.0
    d = m["frontend_dim"]
    for _ in range(m["gru_layers"]):
        f += 2 * (_dense(T, d, 3 * H) + _dense(T, H, 3 * H))
        d = 2 * H
    return f


def transformer_encoder_flops(cfg: dict, T: int) -> float:
    m = cfg["model"]
    D, M = m["tf_dim"], m["tf_mlp"]
    per_layer = (
        4 * _dense(T, D, D)          # q, k, v, out projections
        + 2 * (2.0 * T * T * D)      # scores + attn @ v
        + _dense(T, D, M) + _dense(T, M, D)
    )
    return m["tf_layers"] * per_layer + _dense(T, m["frontend_dim"], D)


def transformer_decoder_flops(cfg: dict, T: int, L: int) -> float:
    m = cfg["model"]
    D, M = m["tf_dim"], m["tf_mlp"]
    per_layer = (
        4 * _dense(L, D, D) + 2 * (2.0 * L * L * D)        # self-attn
        + 2 * _dense(L, D, D)                              # cross k, v proj
        + 2 * (2.0 * L * T * D)                            # cross scores+v
        + 2 * _dense(L, D, D)                              # cross q, out
        + _dense(L, D, M) + _dense(L, M, D)
    )
    return m["tf_dec_layers"] * per_layer + _dense(L, D, m["vocab_size"])


def attn_gru_decoder_flops(cfg: dict, T: int, L: int) -> float:
    """The Bahdanau GRU decoder, teacher-forced over L steps."""
    m = cfg["model"]
    H, A, V = m["decoder_hidden"], m["attn_dim"], m["vocab_size"]
    enc = 2 * m["gru_hidden"]
    f = _dense(T, enc, A)                                  # enc projection
    per_step = (
        _dense(1, H, A) + _dense(T, A, 1) + 2.0 * T * enc  # attend + ctx
        + _dense(1, H + enc, 3 * H) + _dense(1, H, 3 * H)  # gru cell
        + _dense(1, H + enc, V)
    )
    return f + L * per_step


def ctc_head_flops(cfg: dict, T: int) -> float:
    m = cfg["model"]
    enc = 2 * m["gru_hidden"] if cfg["encoder"] == "bigru" else m["tf_dim"]
    return _dense(T, enc, m["vocab_size"])


def model_fwd_flops(cfg: dict, T: int, L: int) -> float:
    """Per-sample forward FLOPs of the configured model, loss heads
    included."""
    f = frontend_flops(cfg, T)
    if cfg["encoder"] == "bigru":
        f += bigru_flops(cfg, T)
    else:
        f += transformer_encoder_flops(cfg, T)
    if cfg["decoder"] in ("ctc", "hybrid"):
        f += ctc_head_flops(cfg, T)
    if cfg["decoder"] in ("attention", "hybrid"):
        if cfg["encoder"] == "bigru":
            f += attn_gru_decoder_flops(cfg, T, L)
        else:
            f += transformer_decoder_flops(cfg, T, L)
    return f


def train_step_flops(cfg: dict, B: int, T: int, L: int) -> float:
    """fwd + bwd ~= 3x fwd (the standard dense-training rule)."""
    return 3.0 * B * model_fwd_flops(cfg, T, L)


def bf16_peak(name: str) -> float | None:
    """Dense bfloat16 FLOP/s of the card ``name``."""
    key = _product(name)
    return None if key is None else _PEAKS[key]["bfloat16"]


def preprocess_flops_conv(pre: dict, H: int, W: int) -> float:
    """Per-frame FLOPs of the tracked conv-landmarker preprocessing: the
    resize to 64 as two products, the detector trunk and head, the
    presence head over the 64 cells, the landmarker's 64 x 64 crop and its
    four convolutions and two dense layers, and the mouth ROI; each
    bilinear crop at 10 operations an output pixel (the ROI kernel's
    count), not as dense products."""
    D = 64
    f = 2.0 * D * H * W + 2.0 * D * W * D
    f += 2.0 * 32 * 32 * 9 * 1 * 8 + 2.0 * 16 * 16 * 9 * 8 * 16 \
        + 2.0 * 8 * 8 * 9 * 16 * 32 + 2.0 * 8 * 8 * 32 * 4
    f += 64 * (2.0 * 32 * 16 + 2.0 * 16)
    f += 10.0 * 64 * 64
    f += (2.0 * 32 * 32 * 9 * 1 * 16 + 2.0 * 16 * 16 * 9 * 16 * 32
          + 2.0 * 8 * 8 * 9 * 32 * 64 + 2.0 * 4 * 4 * 9 * 64 * 96
          + 2.0 * 1536 * 256 + 2.0 * 256 * 136)
    R = pre["roi_size"]
    return f + 10.0 * R * R


def serve_batch_flops(cfg: dict, lengths, H: int = 160, W: int = 160) -> float:
    """FLOPs a serving batch needs, at least: the preprocessing of its real
    frames and the stem, encoder and CTC head of each clip at its real
    length (the beam's decoder steps are not counted)."""
    f = 0.0
    for T in np.asarray(lengths).tolist():
        T = int(T)
        f += T * preprocess_flops_conv(cfg["preprocess"], H, W)
        f += frontend_flops(cfg, T) + transformer_encoder_flops(cfg, T) \
            + ctc_head_flops(cfg, T)
    return f

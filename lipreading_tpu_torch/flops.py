"""Analytic FLOP counts and MFU (counterpart of ``lipreading_tpu/flops.py``).

Counts multiply-accumulate work (2 FLOPs per MAC) of every matrix product
and convolution of the model (the patchify + transformer family, the one
the port runs); elementwise, normalisation and softmax work
is left out, as in the JAX package. ``train_step_flops`` is 3x the forward.

``device_peak_flops`` is NVIDIA's published dense peak of the current card
for the compute type: the H100 SXM (989 TFLOP/s bf16, 67 TFLOP/s float32
outside the tensor cores) and the H100 PCIe (756 and 51); any other card,
or no card, gives None, and then no MFU is logged.
"""

from __future__ import annotations

import math

from lipreading_tpu_torch.config import Config

# dense peak FLOP/s by the product in torch.cuda.get_device_name() and dtype
_PEAKS = {
    "H100 SXM": {"bfloat16": 989e12, "float32": 67e12},
    "H100 PCIe": {"bfloat16": 756e12, "float32": 51e12},
}


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


def _dense(n: int, din: int, dout: int) -> float:
    return 2.0 * n * din * dout


def conv3d_flops(t: int, h: int, w: int, kernel, cin: int, cout: int,
                 strides=(1, 1, 1)) -> float:
    to = -(-t // strides[0])
    ho = -(-h // strides[1])
    wo = -(-w // strides[2])
    return 2.0 * to * ho * wo * math.prod(kernel) * cin * cout


def frontend_flops(cfg: Config, T: int) -> float:
    """Per-sample forward FLOPs of the patchify stem over T frames."""
    m = cfg.model
    R = cfg.preprocess.roi_size                       # 96
    P, ps = m.patch_dim, m.patch_size
    g = R // ps                                        # 12
    f = _dense(T * g * g, 3 * ps * ps, P)              # tubelet embed
    f += conv3d_flops(T, g // 2, g // 2, (3, 3, 3), P, P)     # 6x6
    f += conv3d_flops(T, g // 4, g // 4, (3, 3, 3), P, P)     # 3x3
    f += _dense(T, P * (g // 4) ** 2, m.frontend_dim)
    f += m.highway_layers * 2 * _dense(T, m.frontend_dim, m.frontend_dim)
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


def model_fwd_flops(cfg: Config, T: int, L: int) -> float:
    """Per-sample forward FLOPs of the patchify + transformer model, loss
    heads included (the conv3d stem and the bi-GRU family are not ported)."""
    m = cfg.model
    f = frontend_flops(cfg, T) + transformer_encoder_flops(cfg, T)
    f += _dense(T, m.tf_dim, m.vocab_size)                # CTC head
    if cfg.decoder == "hybrid":
        f += transformer_decoder_flops(cfg, T, L)
    return f


def train_step_flops(cfg: Config, B: int, T: int, L: int) -> float:
    """fwd + bwd ~= 3x fwd (the standard dense-training rule)."""
    return 3.0 * B * model_fwd_flops(cfg, T, L)


def mfu(flops_per_sec: float, dtype: str = "bfloat16") -> float | None:
    peak = device_peak_flops(dtype)
    return None if peak is None else flops_per_sec / peak

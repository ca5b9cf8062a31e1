"""Configuration dataclasses of the lip-reading system.

A copy of the fields of ``lipreading_tpu/config.py`` that this package reads,
so that a release's ``.json`` sidecar loads unchanged through ``from_dict``.
The mesh section of a release config is ignored: this package runs on one
device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any


@dataclass
class PreprocessConfig:
    """Video -> mouth-ROI preprocessing."""

    roi_size: int = 96            # output ROI is roi_size x roi_size grayscale
    roi_margin: float = 0.30      # mouth bbox expansion factor before square-crop
    normalize_mean: float = 0.421  # gray in [0,1] -> (x - mean) / std
    normalize_std: float = 0.165
    detector_input: int = 64      # face detector input resolution (square)
    ert_cascades: int = 10        # ERT landmark cascade stages
    ert_trees: int = 96           # boosted trees per cascade (parallel-friendly)
    ert_depth: int = 4            # split depth per tree (2^d leaves)
    ert_pool: int = 128           # candidate feature pixels per cascade
    # "ert" (this package) or "conv" (the distilled conv landmarker, a
    # later slice of the port)
    landmarker: str = "ert"
    # ROI crop-box coordinates: "round" = integer boxes (the golden-dump
    # contract), "subpixel" = the float mouth box, "auto" = subpixel
    # whenever the landmarker is not the ERT
    roi_sampling: str = "auto"


@dataclass
class DataConfig:
    fps: float = 25.0
    frame_height: int = 160
    frame_width: int = 160
    frames_per_char: int = 4      # synthetic fixture speech rate
    max_frames: int = 128         # T bucket ceiling (static-shape padding)
    max_chars: int = 40           # L bucket ceiling incl. sos/eos
    time_buckets: tuple[int, ...] = (32, 64, 96, 128)
    batch_size: int = 8


@dataclass
class ModelConfig:
    # visual stem: "patchify" (tubelet embed, ported) or "conv3d" (the
    # Conv3d stack, a later slice of the port)
    frontend: str = "conv3d"
    frontend_channels: tuple[int, ...] = (32, 64, 96)
    frontend_dim: int = 256       # feature dim fed to the encoder
    patch_size: int = 8           # patchify stem: space-to-depth patch edge
    patch_dim: int = 256          # patchify stem: embed/conv channel width
    # per-frame GroupNorm statistics in the frontend; off pools them over
    # time, padded frames included. Weights trained one way must be decoded
    # the same way (models/nn.groupnorm).
    framewise_norm: bool = False
    highway_layers: int = 2
    # bi-GRU encoder
    gru_hidden: int = 256
    gru_layers: int = 2
    # attention decoder
    attn_dim: int = 128
    decoder_hidden: int = 256
    # transformer encoder-decoder
    tf_layers: int = 4
    tf_dec_layers: int = 4
    tf_dim: int = 256
    tf_heads: int = 4
    tf_mlp: int = 1024
    dropout: float = 0.1
    vocab_size: int = 31
    dtype: str = "bfloat16"       # activation dtype; params stay fp32
    # flash attention in the encoder (a later slice of the port) and its
    # backward policy
    flash_attention: bool = False
    flash_bwd: str = "auto"


@dataclass
class TrainConfig:
    seed: int = 0
    learning_rate: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 5000
    weight_decay: float = 1e-4
    grad_clip: float = 5.0
    teacher_forcing: float = 1.0
    ctc_weight: float = 1.0       # hybrid CTC/attention loss mix
    att_weight: float = 0.0
    checkpoint_every: int = 500
    eval_every: int = 500
    log_every: int = 50
    beam_width: int = 8
    length_penalty: float = 0.6   # GNMT-style; 0 disables length norm
    max_decode_len: int = 48
    remat: bool = False           # recompute the frontend in the backward
    roi_augment: float = 0.0      # train-time ROI appearance jitter


@dataclass
class Config:
    name: str = "default"
    data: DataConfig = field(default_factory=DataConfig)
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    encoder: str = "bigru"        # "bigru" | "transformer"
    decoder: str = "ctc"          # "ctc" | "attention" | "hybrid"

    def override(self, **dotted: Any) -> "Config":
        """Apply dotted-path overrides, e.g. ``override(**{"train.seed": 3})``;
        a string value is coerced to the field's type."""
        cfg = dataclasses.replace(self)
        for key, value in dotted.items():
            parts = key.split(".")
            obj = cfg
            for p in parts[:-1]:
                if not is_dataclass(getattr(obj, p, None)):
                    raise KeyError(f"no config field {key!r}")
                child = dataclasses.replace(getattr(obj, p))
                setattr(obj, p, child)
                obj = child
            leaf = parts[-1]
            if not hasattr(obj, leaf):
                raise KeyError(f"no config field {key!r}")
            cur = getattr(obj, leaf)
            if cur is not None and not isinstance(value, type(cur)):
                value = _coerce(value, cur)
            setattr(obj, leaf, value)
        return cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _coerce(value: Any, like: Any) -> Any:
    t = type(like)
    if t is bool:
        return str(value).lower() in ("1", "true", "yes")
    if t is tuple:
        items = str(value).strip("()[] ").split(",")
        elem = type(like[0]) if like else int
        return tuple(elem(i) for i in items if i.strip())
    return t(value)


def parse_overrides(argv: list[str]) -> dict[str, str]:
    """``['train.seed=3', ...]`` -> ``{'train.seed': '3', ...}``."""
    out = {}
    for a in argv:
        if "=" not in a:
            raise ValueError(f"override must be key=value, got {a!r}")
        k, v = a.split("=", 1)
        out[k] = v
    return out


def preset(name: str) -> Config:
    """A named configuration of the JAX package's ``preset``. Only the
    patchify + transformer family is ported; the other presets (conv3d stem,
    bi-GRU) are later slices."""
    presets = {
        # the flagship training configuration: patchify stem, transformer
        # encoder, hybrid CTC/attention loss
        "transformer-patchify": Config(
            name="transformer-patchify",
            encoder="transformer",
            decoder="hybrid",
            model=ModelConfig(frontend="patchify"),
            train=TrainConfig(ctc_weight=0.3, att_weight=0.7),
        ),
    }
    if name not in presets:
        raise KeyError(f"unknown or not yet ported preset {name!r}; have "
                       f"{sorted(presets)}")
    return presets[name]


def from_dict(d: dict) -> Config:
    """Rebuild a Config from ``to_dict()`` output (a release's ``config``)."""
    def build(cls, sub):
        kwargs = {}
        for f in fields(cls):
            if f.name not in sub:
                continue
            v = sub[f.name]
            if is_dataclass(f.type) if isinstance(f.type, type) else False:
                kwargs[f.name] = build(f.type, v)
            elif isinstance(v, list):
                kwargs[f.name] = tuple(v)
            else:
                kwargs[f.name] = v
        return cls(**kwargs)

    cfg = Config(
        name=d.get("name", "default"),
        data=build(DataConfig, d.get("data", {})),
        preprocess=build(PreprocessConfig, d.get("preprocess", {})),
        model=build(ModelConfig, d.get("model", {})),
        train=build(TrainConfig, d.get("train", {})),
        encoder=d.get("encoder", "bigru"),
        decoder=d.get("decoder", "ctc"),
    )
    return cfg

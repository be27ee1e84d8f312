"""Configuration of the port: the fields the GT-free serving path reads.

Counterpart of ``multimodal_feature_learning_tpu/config/defaults.py``, as
plain dataclasses. Attribute paths match the JAX config (``cfg.dvc.detr.rho``,
``cfg.dataset.activity_net.video_rescale_len``) and the defaults are its
defaults, so one set of overrides describes the same model on both sides.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class DetrConfig:
    feature_dim: int = 512
    d_model: int = 512
    num_heads: int = 8
    num_feature_levels: int = 4
    dec_n_points: int = 4
    enc_n_points: int = 4
    enc_layers: int = 6
    dec_layers: int = 6
    transformer_ff_dim: int = 2048
    video_rescale_len: int = 300
    rho: float = 0.5
    use_enc_aux_loss: bool = True


@dataclass
class CaptionConfig:
    d_model: int = 512
    depth: int = 6
    num_heads: int = 8
    mlp_ratio: float = 4
    qkv_bias: bool = True


@dataclass
class DVCConfig:
    d_model: int = 512
    num_queries: int = 20
    max_eseq_length: int = 10
    use_sparse_detr: bool = True
    detr: DetrConfig = field(default_factory=DetrConfig)
    caption: CaptionConfig = field(default_factory=CaptionConfig)


@dataclass
class ActivityNetConfig:
    video_rescale_len: int = 300
    max_caption_len_all: int = 20
    max_gt_target_segments: int = 10


@dataclass
class DatasetConfig:
    activity_net: ActivityNetConfig = field(default_factory=ActivityNetConfig)


@dataclass
class Config:
    use_differentiable_mask: bool = True
    compute_dtype: str = "float32"
    decode_impl: str = "xla"
    dvc: DVCConfig = field(default_factory=DVCConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)


def load_config() -> Config:
    return Config()

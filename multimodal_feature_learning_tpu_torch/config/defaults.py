"""Configuration of the port: the fields the serving, training and evaluation
paths read.

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
    transformer_dropout_prob: float = 0.1
    rho: float = 0.5
    use_enc_aux_loss: bool = True


@dataclass
class CaptionConfig:
    d_model: int = 512
    depth: int = 6
    num_heads: int = 8
    mlp_ratio: float = 4
    qkv_bias: bool = True
    positional_embedding_dropout: float = 0.1
    attention_dropout: float = 0.1
    projection_dropout: float = 0.1
    bridge_dropout: float = 0.1  # the multimodal caption layers' concat bridge
    mlp_dropout_1: float = 0.1
    mlp_dropout_2: float = 0.1
    # GloVe word embeddings (models/load_weights.py): the vectors' width, the
    # GloVe text file ("" or a missing file: a plain embedding), and the
    # pickle cache of the vocabulary's matrix
    pretrained_word_embed_dim: int = 300
    glove_file_path: str = ""
    embedding_matrix_file_path: str = "embedding_matrix.pkl"


@dataclass
class MatcherConfig:
    cost_segment: float = 5.0
    cost_giou: float = 2.0


@dataclass
class DecoderConfig:
    """The regular family's query decoder (``models/regular_dvc.py``): its
    depth, the one field of JAX's ``dvc.decoder`` that JAX reads (its width
    and heads are d_model's and dvc.detr.num_heads)."""
    depth: int = 6


@dataclass
class VivitConfig:
    """The raw multimodal family's ViViT (``models/backbones.py``). JAX's
    default of 12 heads does not divide d_model 512: the attention's reshape
    fails there, in both packages, so a full-width run sets 8."""
    model_name: str = "factorised encoder"
    depth: int = 12
    temporal_depth: int = 4
    num_heads: int = 12
    spatial_patch_size: int = 16
    temporal_patch_size: int = 1


@dataclass
class AstConfig:
    """The raw multimodal family's audio spectrogram transformer."""
    depth: int = 12
    num_heads: int = 12
    patch_size: int = 16
    frequency_stride: int = 10
    time_stride: int = 10


@dataclass
class DVCConfig:
    # ["video"]: the unimodal families; ["video", "audio"]: the multimodal one
    input_modalities: list = field(default_factory=lambda: ["video"])
    # BiModalEncoder fusion of the video and audio features ahead of the
    # multimodal proposal stack
    use_bimodal_encoder: bool = False
    bimodal_depth: int = 2
    d_model: int = 512
    num_queries: int = 20
    num_classes: int = 200  # the dense family's class head: num_classes + 1 logits
    max_eseq_length: int = 10
    aux_loss: bool = True
    lloss_gau_mask: int = 1
    lloss_beta: float = 1.0
    # the family: sparse (Sparse-DETR encoder, top-rho tokens), dense
    # (use_sparse_detr False, use_deformable_detr True: every token a query,
    # and a class head), or regular (both False: a vanilla query decoder over
    # the frame features, models/regular_dvc.py)
    use_sparse_detr: bool = True
    use_deformable_detr: bool = False
    smoothing: float = 0.5  # caption label smoothing epsilon
    cls_loss_coef: float = 1.0
    counter_loss_coef: float = 2.0
    bbox_loss_coef: float = 5.0
    giou_loss_coef: float = 2.0
    self_iou_loss_coef: float = 2.0
    caption_loss_coef: float = 1.0
    context_loss_coef: float = 3.0
    mask_prediction_coef: float = 2.0
    corr_coef: float = 2.0
    # derived from the flags by recompute_losses, as the JAX config does
    losses: list = field(default_factory=lambda: [
        "labels", "segments", "captions", "contexts", "mask_prediction"])
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    detr: DetrConfig = field(default_factory=DetrConfig)
    caption: CaptionConfig = field(default_factory=CaptionConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    vivit: VivitConfig = field(default_factory=VivitConfig)
    ast: AstConfig = field(default_factory=AstConfig)


@dataclass
class ActivityNetConfig:
    anet_path: str = "./anet_data"  # the annotation JSON files of each split
    # a directory of <video key>.npy feature arrays (num_tokens, feature_dim);
    # "" = deterministic synthetic features (data.anet.FeatureBackend)
    video_features_file: str = ""
    # the same for the audio features; "" reads the video features as audio,
    # as the JAX package does (the reference ships no audio features)
    audio_features_file: str = ""
    invalid_videos_json: str = ""
    for_testing: bool = False
    num_samples: int = 6
    vocab_file_path: str = "./vocab.pkl"
    min_freq: int = 2
    video_rescale_len: int = 300
    audio_rescale_len: int = 50
    # raw ingest (use_raw_videos): the log-mel bins and frames of each clip
    num_mel_bins: int = 128
    audio_target_length: int = 64
    max_caption_len_all: int = 20
    max_gt_target_segments: int = 10
    num_classes: int = 200
    val_subset: int = 0  # > 0: evaluate the first val_subset sorted val keys
    train_subset: int = 0  # > 0: train on the first train_subset sorted train keys
    # raw ingest: a folder of <key>.<video ext> files read by the OpenCV
    # decoder (when cv2 imports; else the synthetic decoder), and optional
    # <key>.wav sidecars for its audio
    raw_video_folder: str = ""
    raw_audio_folder: str = ""


@dataclass
class DatasetConfig:
    activity_net: ActivityNetConfig = field(default_factory=ActivityNetConfig)


@dataclass
class EvalConfig:
    tious: list = field(default_factory=lambda: [0.3, 0.5, 0.7, 0.9])
    max_proposals_per_video: int = 100
    verbose: bool = False
    val_mode: str = "one_by_one"  # one_by_one | teacher_forcing | beam | serve
    # semantic, not a speed-up: the raw argmax fills every caption slot, so
    # the decode runs all seq_len steps and has no all-done early exit
    faster_eval: bool = False
    beam_size: int = 4
    length_penalty: float = 0.0


@dataclass
class Config:
    seed: int = 0
    batch_size: int = 16
    print_freq: int = 10
    output_dir: str = "output"
    submission_dir: str = "output/submission"
    save_submission: bool = True
    lr: float = 1e-4
    lr_drop: int = 40  # StepLR: lr *= 0.1 every lr_drop epochs
    weight_decay: float = 1e-4
    clip_max_norm: float = 0.1
    checkpoint_rate: int = 10  # keep checkpoint{epoch:04d} every N epochs (0: never)
    eval_rate: int = 10        # evaluate every N epochs (0: the last epoch only)
    epochs: int = 200
    start_epoch: int = 0
    resume: str = ""           # a checkpoint to resume from, at its epoch + 1
    use_differentiable_mask: bool = True
    # raw uint8 frames (and log-mel spectrograms) in the batches, through
    # ViViT (and AST) inside the model: data/raw_anet.py
    use_raw_videos: bool = False
    # numerics, as the JAX package: "bfloat16" runs every forward over bf16
    # copies of the float params and the features (utils/precision.py);
    # "float32" (the default) is the full-f32 path
    compute_dtype: str = "float32"
    # training's master params and AdamW moments: "bfloat16" folds them
    # (engine/state.py); the default keeps f32 masters
    master_dtype: str = "float32"
    decode_impl: str = "xla"      # "xla" (plain-op loop) | "fused" (one kernel a step)
    decode_kv: str = "dense"       # fused path's memory K/V: "dense" | "int8"
    decode_fused_grid: str = "video"  # fused kernel's schedule: "video" | "batch"
    # dtype of the features on their way to the card: "bfloat16" halves the
    # bytes, and they are upcast to f32 there
    transfer_dtype: str = "float32"
    # K optimizer steps per dispatch of the training loop
    # (engine/train.py::make_train_multistep), the batches of a dispatch
    # sent in one transfer; 1 runs single steps
    steps_per_dispatch: int = 1
    dvc: DVCConfig = field(default_factory=DVCConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)


DECODE_CHOICES = {
    "decode_impl": ("xla", "fused"),
    "decode_kv": ("dense", "int8"),
    "decode_fused_grid": ("video", "batch"),
    "val_mode": ("one_by_one", "teacher_forcing", "beam", "serve"),
    "rank": ("stability", "class"),
}


def check_decode_options(**options) -> None:
    """Raise ``ValueError`` on an unknown value of a decode knob, of
    ``val_mode`` or of the serving ``rank``."""
    for name, value in options.items():
        if value not in DECODE_CHOICES[name]:
            raise ValueError(f"{name} must be one of {DECODE_CHOICES[name]}, got {value!r}")


def recompute_losses(cfg: Config) -> None:
    """Re-derive ``cfg.dvc.losses`` from the mask and family flags; call it
    after changing them, as the JAX package's ``recompute_losses``."""
    losses = ["labels", "segments", "captions"]
    if cfg.use_differentiable_mask:
        losses.append("contexts")
    if cfg.dvc.use_sparse_detr:
        losses.append("mask_prediction")
    cfg.dvc.losses = losses


def load_config() -> Config:
    return Config()


def apply_overrides(cfg: Config, overrides) -> Config:
    """Apply ``a.b.c=value`` overrides in place, as the JAX package's
    ``main.py::apply_overrides`` does: the value takes the type of the
    field's current value (bool from "1"/"true"/"True"; a list from
    comma-separated items of its first element's type)."""
    for kv in overrides:
        key, val = kv.split("=", 1)
        node = cfg
        parts = key.split(".")
        for part in parts[:-1]:
            node = getattr(node, part)
        old = getattr(node, parts[-1])
        typ = type(old)
        if typ is bool:
            new = val in ("1", "true", "True")
        elif typ is list:
            items = [v for v in val.split(",") if v]
            el = type(old[0]) if old else str
            new = [el(v) for v in items] if el is not str else items
        else:
            new = typ(val)
        setattr(node, parts[-1], new)
    return cfg

"""Reference SAGA-DVC checkpoints into the port's flagship model, and back.

Counterpart of the JAX package's ``utils/ref_bridge.py`` (``transplant``,
``import_reference_state_dict``, ``load_reference_checkpoint``). A user of
the reference brings a trained ``.pth`` (its ``main.py`` saves
``{'model': state_dict, ...}``) onto the card without retraining, and takes
the port's weights back as such a file.

The reference is PyTorch like the port, so a ``Linear``'s (out, in) weight
and a ``Conv1d``'s (out, in, k) weight carry over as they are: the mapping
is a rename of the port's state_dict names (``_RENAMES``) plus one layout
change, the proposal decoder's self-attention, whose separate q / k / v
``Linear``s are ``nn.MultiheadAttention``'s ``in_proj_weight`` /
``in_proj_bias`` in the reference, rows ``[q; k; v]``. With
``use_enc_aux_loss`` the reference also holds the encoder heads under a
second name inside its transformer (``_ALIASES``): they are written twice
and read once.

Only the flagship sparse family (``UnimodalSparseDVC`` in the reference,
``models.dvc.UnimodalDVC`` with ``dvc.use_sparse_detr``) carries over; the
other families raise ``ValueError``. The JAX module's
``make_reference_importable``, ``build_reference_model`` and
``load_into_reference`` run the reference's own code and have no
counterpart here.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, List

import torch
from torch import nn

_T = "unimodal_sparse_transformer"
_CAPTION = "unimodal_caption_decoder"

# port state_dict name -> reference name, the first matching rule
_RENAMES = [(re.compile(pattern), repl) for pattern, repl in (
    (r"^proposal\.query_embedding$", "query_embedding.weight"),
    (r"^proposal\.(?=(segment_embedding|count_head)_(en|de)coder\.)", ""),
    (r"^proposal\.base_encoder\.(?=pos_embed\.)", ""),
    (r"^proposal\.base_encoder\.input_proj\.(\d+)\.", r"base_encoder.input_proj.\1.0."),
    (r"^proposal\.base_encoder\.gn\.(\d+)\.", r"base_encoder.input_proj.\1.1."),
    (r"^proposal\.transformer\.reference_points_head\.", f"{_T}.reference_points."),
    (r"^proposal\.transformer\.enc_mask_predictor\.norm\.", f"{_T}.enc_mask_predictor.layer1.0."),
    (r"^proposal\.transformer\.enc_mask_predictor\.dense_in\.",
     f"{_T}.enc_mask_predictor.layer1.1."),
    (r"^proposal\.transformer\.enc_mask_predictor\.dense_1\.",
     f"{_T}.enc_mask_predictor.layer2.0."),
    (r"^proposal\.transformer\.enc_mask_predictor\.dense_2\.",
     f"{_T}.enc_mask_predictor.layer2.2."),
    (r"^proposal\.transformer\.enc_mask_predictor\.dense_out\.",
     f"{_T}.enc_mask_predictor.layer2.4."),
    (r"^proposal\.transformer\.enc_layers\.", f"{_T}.encoder.layers."),
    (r"^proposal\.transformer\.dec_layers\.(\d+)\.self_attn\.projection_layer\.",
     rf"{_T}.decoder.layers.\1.self_attn.out_proj."),
    (r"^proposal\.transformer\.dec_layers\.", f"{_T}.decoder.layers."),
    (r"^proposal\.transformer\.(?=level_embed$|enc_output\.|enc_output_norm\.)", f"{_T}."),
    (r"^caption\.target_embedding\.embed\.weight$",
     f"{_CAPTION}.target_embedding.embedder.weight"),
    (r"^caption\.(?=decoder\.|head\.)", f"{_CAPTION}."),
    (r"^context_mask\.", "context_mask_model."),
)]
# the proposal decoder's self-attention: a third of in_proj each, rows [q; k; v]
_QKV = re.compile(r"^proposal\.transformer\.dec_layers\.(\d+)\.self_attn\.([qkv])_linear\."
                  r"(weight|bias)$")
# with use_enc_aux_loss the reference aliases the encoder heads into its
# transformer's encoder: its state_dict holds both names
_ALIASES = (("segment_embedding_encoder.", f"{_T}.encoder.segment_embedding."),
            ("count_head_encoder.", f"{_T}.encoder.count_head."))
# reference state_dict entries the port has no place for, skipped silently
# (the context mask is taken only where the model has one)
_UNUSED_PREFIXES = ("context_mask_model", f"{_CAPTION}.positional_encoding")


def _reference_name(name: str):
    """(reference name, slot) of a port state_dict name: slot 0 / 1 / 2 for
    the q / k / v third of an ``in_proj_*`` tensor, else None; (None, None)
    for a name the reference has no counterpart of (a GloVe projection)."""
    m = _QKV.match(name)
    if m:
        return f"{_T}.decoder.layers.{m[1]}.self_attn.in_proj_{m[3]}", "qkv".index(m[2])
    for pattern, repl in _RENAMES:
        if pattern.match(name):
            return pattern.sub(repl, name, count=1), None
    return None, None


def _check_flagship(model: nn.Module, cfg) -> None:
    from ..models.dvc import UnimodalDVC

    if not (isinstance(model, UnimodalDVC) and cfg.dvc.use_sparse_detr):
        raise ValueError(
            "reference-checkpoint import and export support the flagship "
            "UnimodalSparseDVC family only (the port's UnimodalDVC with "
            f"dvc.use_sparse_detr); got {type(model).__name__} with "
            f"use_sparse_detr={cfg.dvc.use_sparse_detr}, "
            f"use_deformable_detr={cfg.dvc.use_deformable_detr}")


def _aliases(ref: str):
    for src, dst in _ALIASES:
        if ref.startswith(src):
            yield dst + ref[len(src):]


def reference_state_dict(model: nn.Module, cfg) -> Dict[str, torch.Tensor]:
    """The model's weights as the reference's ``state_dict``: its names and
    layouts, CPU tensors in the model's dtypes (JAX ``transplant``). The
    context mask goes with it where the model has one."""
    _check_flagship(model, cfg)
    sd: Dict[str, torch.Tensor] = {}
    thirds: Dict[str, list] = {}
    for name, t in model.state_dict().items():
        ref, slot = _reference_name(name)
        if ref is None:
            continue
        t = t.detach().to("cpu", copy=True)
        if slot is None:
            sd[ref] = t
        else:
            thirds.setdefault(ref, [None] * 3)[slot] = t
    for ref, parts in thirds.items():
        sd[ref] = torch.cat(parts)
    if cfg.dvc.detr.use_enc_aux_loss:
        for ref in list(sd):
            for alias in _aliases(ref):
                sd[alias] = sd[ref].clone()
    return sd


def import_reference_state_dict(state_dict, model: nn.Module, cfg) -> List[str]:
    """Load a reference ``state_dict`` into ``model`` (JAX
    ``import_reference_state_dict``). Every tensor the model needs must be
    there (else KeyError), and every shape must match the model's (else
    ValueError naming the first leaves that do not, before anything is
    loaded). The aliased encoder heads are read and not loaded twice; the
    context mask is loaded where the model has one and the file holds it,
    else the model keeps its own. Returns the sorted keys of the file that
    were not used and are not under ``_UNUSED_PREFIXES``."""
    _check_flagship(model, cfg)
    used = set()

    def read(key):
        if key not in state_dict:
            raise KeyError(f"the reference checkpoint lacks {key!r}")
        used.add(key)
        return state_dict[key]

    own = model.state_dict()
    with_mask = "context_mask_model.layer_1.weight" in state_dict
    new = {}
    for name in own:
        ref, slot = _reference_name(name)
        if ref is None or (ref.startswith("context_mask_model.") and not with_mask):
            continue
        t = read(ref)
        if slot is not None:
            d = read(ref.replace("in_proj_bias", "in_proj_weight")).shape[1]
            t = t[slot * d:(slot + 1) * d]
        new[name] = t
        if cfg.dvc.detr.use_enc_aux_loss:
            for alias in _aliases(ref):
                read(alias)
    bad = [(name, tuple(own[name].shape), tuple(t.shape)) for name, t in new.items()
           if tuple(t.shape) != tuple(own[name].shape)]
    if bad:
        raise ValueError("reference checkpoint does not match this model's config "
                         "(leaf, expected shape, checkpoint shape): " + repr(bad[:5]))
    model.load_state_dict(new, strict=False)
    return sorted(k for k in state_dict
                  if k not in used and not k.startswith(_UNUSED_PREFIXES))


def load_reference_checkpoint(path: str, model: nn.Module, cfg,
                              trust_pickle: bool = False) -> List[str]:
    """Load a reference ``torch.save``d checkpoint (``{'model':
    state_dict, ...}`` or a bare state_dict) into ``model``; returns the
    leftover keys of ``import_reference_state_dict``. The file is read on
    the CPU and the tensors go to the model's device as they load.

    Safe by default: ``weights_only=True`` executes no code from the file.
    A file with other objects (a config, an optimizer), which it refuses
    with ``pickle.UnpicklingError``, needs the full unpickler, which runs
    code embedded in it: ``trust_pickle=True``
    (``--trust-checkpoint`` on the CLIs) only for a file from a trusted
    source."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:  # what the safe unpickler refuses
        if not trust_pickle:
            raise ValueError(
                f"{path}: safe (weights_only) load failed: {e}. The file needs the full "
                "pickle loader, which executes code embedded in the checkpoint; re-run "
                "with --trust-checkpoint (or trust_pickle=True) if you trust its "
                "source.") from e
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return import_reference_state_dict(sd, model, cfg)

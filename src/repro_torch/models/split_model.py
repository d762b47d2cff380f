"""The paper's hybrid decomposition θ = [θ0 (combined), θ1 (hospital), θ2 (device)].

A ``HybridModel`` exposes exactly the objects Algorithm 1 manipulates:
  h1(θ1, X1) -> ζ1      hospital tower
  h2(θ2, X2) -> ζ2      device tower
  loss(θ0, ζ1, ζ2, y)   combined model + loss

Instantiations:
  * cnn_hybrid / lstm_hybrid — the paper's own e-health models, with the
    exact vertical feature split of §VII-A.
  * llm_hybrid — the assigned LLM-scale architectures: in the text arm
    the hospital and the device each hold a segment of the sequence; in the
    audio arm (whisper) the hospital holds the audio frames and the device
    the decoder's tokens; in the VLM arm (qwen2-vl) the hospital holds the
    patch embeddings and the device the tokens. The towers are ``n_tower``
    blocks at full width, and the combined model is the architecture's
    backbone (whisper's encoder-decoder) + an untied head.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.pytree import tree_map
from repro_torch.models import cnn as C
from repro_torch.models import layers as L
from repro_torch.models import lstm as R
from repro_torch.models import transformer as T


@dataclass(frozen=True)
class HybridModel:
    name: str
    specs0: Any  # combined θ0
    specs1: Any  # hospital θ1
    specs2: Any  # device θ2
    h1: Callable  # (θ1, x1) -> ζ1
    h2: Callable  # (θ2, x2) -> ζ2
    loss: Callable  # (θ0, ζ1, ζ2, y) -> scalar
    predict: Callable  # (θ0, ζ1, ζ2) -> outputs

    def specs(self) -> Dict[str, Any]:
        return {"theta0": self.specs0, "theta1": self.specs1, "theta2": self.specs2}

    def init(self, generator: torch.Generator, dtype=torch.float32, device="cpu"):
        return {
            part: L.init_params(specs, generator, dtype, device)
            for part, specs in self.specs().items()
        }

    def params_from_numpy(self, tree, device) -> Dict[str, Any]:
        """The reference's ``HybridModel.init`` output (leaves converted with
        ``np.asarray``) as this package's parameter dict on ``device``.

        Every leaf's shape is checked against the specs; a missing or
        mismatched leaf raises.
        """

        def convert(spec, arr):
            arr = np.asarray(arr)
            if tuple(arr.shape) != tuple(spec.shape):
                raise ValueError(f"param shape {arr.shape} does not match spec {spec.shape}")
            return torch.as_tensor(arr.copy(), device=device)

        specs = self.specs()
        if set(tree) != set(specs):
            raise ValueError(f"expected parts {sorted(specs)}, got {sorted(tree)}")
        return tree_map(convert, specs, tree)

    def full_loss(self, params, x1, x2, y):
        """Centralized view: fresh towers + combined (used by baselines/tests)."""
        z1 = self.h1(params["theta1"], x1)
        z2 = self.h2(params["theta2"], x2)
        return self.loss(params["theta0"], z1, z2, y)


def cnn_hybrid(
    h_rows: int = 11,
    width: int = 28,
    n_classes: int = 11,
    embed_dim: int = 64,
) -> HybridModel:
    """OrganAMNIST: hospital holds top h_rows rows (≈300px), device the rest."""
    d_rows = width - h_rows

    def h1(t, x1):
        return C.tower_forward(t, x1, h_rows, width)

    def h2(t, x2):
        return C.tower_forward(t, x2, d_rows, width)

    def predict(t0, z1, z2):
        return C.combined_forward(t0, z1, z2)

    def loss(t0, z1, z2, y):
        return C.classification_loss(predict(t0, z1, z2), y)

    return HybridModel(
        name="paper_cnn",
        specs0=C.combined_specs(embed_dim, n_classes),
        specs1=C.tower_specs(h_rows, width, embed_dim=embed_dim),
        specs2=C.tower_specs(d_rows, width, embed_dim=embed_dim),
        h1=h1,
        h2=h2,
        loss=loss,
        predict=predict,
    )


def lstm_hybrid(
    n_features: int = 76,
    hospital_features: int = 36,
    n_classes: int = 2,
    d_hidden: int = 64,
    embed_dim: int = 64,
) -> HybridModel:
    """MIMIC-III / ESR: per-timestep feature split (36/40 for MIMIC)."""
    dev_features = n_features - hospital_features

    def predict(t0, z1, z2):
        return C.combined_forward(t0, z1, z2)

    def loss(t0, z1, z2, y):
        return C.classification_loss(predict(t0, z1, z2), y)

    return HybridModel(
        name="paper_lstm",
        specs0=C.combined_specs(embed_dim, n_classes),
        specs1=R.tower_specs(hospital_features, d_hidden, embed_dim),
        specs2=R.tower_specs(dev_features, d_hidden, embed_dim),
        h1=R.tower_forward,
        h2=R.tower_forward,
        loss=loss,
        predict=predict,
    )


# ---------------------------------------------------------------------------
# LLM-scale hybrid (assigned architectures)
# ---------------------------------------------------------------------------


def _tower_cfg(cfg: ModelConfig, n_tower: int) -> ModelConfig:
    """Family-consistent tower blocks at full width, shallow depth."""
    kw = dict(num_layers=n_tower, first_dense_layers=0, num_experts=0,
              experts_per_token=0, num_shared_experts=0)
    if cfg.family in ("ssm", "hybrid"):
        return cfg.replace(family="ssm", **kw)
    if cfg.d_ff == 0:  # attention-free cfg needs an ff for dense tower blocks
        kw["d_ff"] = 4 * cfg.d_model
    return cfg.replace(family="dense", attention=cfg.attention, hybrid_attn_every=0, **kw)


def _tower_stack_specs(cfg: ModelConfig, n_tower: int, with_embed: bool):
    tcfg = _tower_cfg(cfg, n_tower)
    kind = "mamba" if tcfg.family == "ssm" else "attn_mlp"
    s = {"layers": T.stack_specs(tcfg, n_tower, kind), "norm": L.norm_specs(cfg.norm, cfg.d_model)}
    if with_embed:
        s["embed"] = L.embed_specs(cfg.vocab_size, cfg.d_model)
    return s, tcfg


def _tower_forward(tcfg: ModelConfig, params, x_or_tokens, remat=True):
    if "embed" in params:
        x = L.embed(params["embed"], x_or_tokens)
        # the reference's sqrt(float32(d)), rounded to x's dtype
        scale = torch.sqrt(torch.tensor(float(tcfg.d_model), dtype=torch.float32))
        x = x * float(scale.to(x.dtype))
    else:
        x = x_or_tokens
    x, _ = T.backbone_forward(tcfg, {"layers": params["layers"]}, x, remat=remat)
    return L.apply_norm(tcfg.norm, params["norm"], x)


def llm_hybrid(cfg: ModelConfig, n_tower: int = 2, remat: bool = True) -> HybridModel:
    """Wrap an assigned architecture into the paper's hybrid decomposition.

    Text arm: the hospital and the device towers each embed a segment of
    the token sequence. Audio and VLM arms: the hospital tower has no
    embedding and runs over float modality embeddings (whisper's frames
    [B, Se, d], qwen2-vl's patches [B, 8, d]); as in the reference it is a
    dense tower (``_tower_cfg``), causal, with RoPE over the frames, or
    M-RoPE over the patches' text ids (the tower keeps
    ``mrope_sections``). Audio: ζ1 is the encoder's input and the device
    tower's ζ2 the decoder's. VLM: the combined model runs its backbone
    over ζ1 then ζ2 on text ids, not the patch grid, as the reference
    does."""
    # hospital tower: modality embeddings for audio and vlm, a token segment otherwise
    modality = cfg.family in ("audio", "vlm")
    s1, tcfg1 = _tower_stack_specs(cfg, n_tower, with_embed=not modality)
    s2, tcfg2 = _tower_stack_specs(cfg, n_tower, with_embed=True)

    specs0 = T.model_specs(cfg)
    del specs0["embed"]  # combined model consumes ζ, not tokens
    specs0["head"] = L.dense_specs(cfg.d_model, cfg.vocab_size, (None, "vocab"), scale=0.02)

    def h1(t1, x1):
        return _tower_forward(tcfg1, t1, x1, remat)

    def h2(t2, x2):
        return _tower_forward(tcfg2, t2, x2, remat)

    def hidden_fn(t0, z1, z2):
        if cfg.family == "audio":
            x = T.audio_forward(t0, z2, z1, cfg, remat)
        else:
            x = torch.cat([z1.to(z2.dtype), z2], dim=1)
            x, _ = T.backbone_forward(cfg, t0, x, remat=remat)
        return L.apply_norm(cfg.norm, t0["final_norm"], x)

    def predict(t0, z1, z2):
        return L.dense(t0["head"], hidden_fn(t0, z1, z2))

    def loss(t0, z1, z2, y):
        # labels cover the token region (hospital + device segments; the
        # decoder's tokens for audio and vlm)
        hidden = hidden_fn(t0, z1, z2)[:, -y.shape[1]:]
        # fused chunked head + cross-entropy: the full logits never materialize
        head_cfg = cfg.replace(tie_embeddings=False)
        return T.chunked_lm_head_loss(head_cfg, t0, hidden, y, remat)

    return HybridModel(
        name=f"hybrid_{cfg.name}",
        specs0=specs0,
        specs1=s1,
        specs2=s2,
        h1=h1,
        h2=h2,
        loss=loss,
        predict=predict,
    )

"""Feed-forward variants: SwiGLU / GeGLU (gated), squared-ReLU, plain GELU."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.sharding import constrain, use_weight
from repro_torch.models import layers as L


def mlp_specs(cfg: ModelConfig, d_ff: int = 0) -> Dict[str, L.Spec]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": L.Spec((d, f), ("embed", "mlp")),
            "w_up": L.Spec((d, f), ("embed", "mlp")),
            "w_down": L.Spec((f, d), ("mlp", "embed")),
        }
    return {
        "w_up": L.Spec((d, f), ("embed", "mlp")),
        "w_down": L.Spec((f, d), ("mlp", "embed")),
    }


def mlp_forward(params, x, cfg: ModelConfig):
    if cfg.mlp == "swiglu":
        act = L.ACTIVATIONS["silu"]
    elif cfg.mlp == "squared_relu":
        act = L.squared_relu
    else:  # geglu | gelu
        act = L.ACTIVATIONS["gelu"]

    if cfg.mlp in ("swiglu", "geglu"):
        wg = use_weight(params["w_gate"], ("embed", "mlp"))
        wu = use_weight(params["w_up"], ("embed", "mlp"))
        h = act(torch.matmul(x, wg.to(x.dtype))) * torch.matmul(x, wu.to(x.dtype))
    else:
        wu = use_weight(params["w_up"], ("embed", "mlp"))
        h = act(torch.matmul(x, wu.to(x.dtype)))
    h = constrain(h, ("batch", "seq", "mlp"))
    wd = use_weight(params["w_down"], ("mlp", "embed"))
    return constrain(torch.matmul(h, wd.to(x.dtype)), ("batch", "seq", "embed"))

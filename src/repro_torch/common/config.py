"""Model configs with their registry, and the federation / training
configuration (the paper's hyper-parameters).

Same fields, defaults and validation errors as ``repro/common/config.py``.
The registry holds the architectures the port runs (``repro_torch/configs``:
the paper's CNN and LSTM, the dense family, Mamba-1, the zamba2 hybrid,
the whisper encoder-decoder, the MoE family, grok-1 and deepseek-v3
with MLA, and the qwen2-vl VLM): every architecture of the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (all the reference's fields; the port runs
    every family but the VLM one)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm | cnn | lstm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # --- attention flavour ---
    attention: str = "gqa"  # gqa | mla | none
    sliding_window: int = 0  # 0 -> full attention
    local_global_ratio: int = 0  # gemma3: 5 local per 1 global
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) splits
    # --- MLA (deepseek) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- MLP flavour ---
    mlp: str = "swiglu"  # swiglu | geglu | squared_relu | gelu
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # expert hidden size if != d_ff
    first_dense_layers: int = 0  # deepseek: first k layers dense
    # --- SSM (mamba) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_version: int = 1  # 1 = mamba1 (falcon-mamba), 2 = mamba2 (zamba2)
    ssm_headdim: int = 64  # mamba2 head dim
    hybrid_attn_every: int = 0  # zamba2: shared attention block period
    # --- structure ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0  # stubbed frontend sequence length (whisper frames / ViT patches)
    frontend: str = ""  # "audio" | "vision" stub marker
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = True
    max_seq_len: int = 131072
    dtype: str = "bfloat16"
    # provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    def param_count(self) -> int:
        """Analytic parameter count (the reference's formula, all families)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        attn = 0
        if self.attention == "gqa" and self.num_heads:
            attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        elif self.attention == "mla":
            attn = d * self.q_lora_rank + self.q_lora_rank * self.num_heads * (hd + self.qk_rope_head_dim)
            attn += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            attn += self.kv_lora_rank * self.num_heads * (hd + self.v_head_dim)
            attn += self.num_heads * self.v_head_dim * d
        if self.family != "hybrid":
            per_layer += attn
        if self.family in ("ssm", "hybrid"):
            d_in = self.ssm_expand * d
            N = self.ssm_state
            if self.ssm_version == 1:
                dt_rank = max(1, d // 16)
                per_layer += d * 2 * d_in + d_in * (2 * N + dt_rank) + dt_rank * d_in
            else:
                H = d_in // max(self.ssm_headdim, 1)
                per_layer += d * (2 * d_in + 2 * N + H)
            per_layer += d_in * self.ssm_conv + d_in * d
        mults = 3 if self.mlp in ("swiglu", "geglu") else 2
        if self.num_experts > 0:
            eff = self.moe_d_ff or self.d_ff
            per_layer += self.num_experts * mults * d * eff
            per_layer += self.num_shared_experts * mults * d * eff
            per_layer += d * self.num_experts  # router
        elif self.d_ff > 0 and self.family != "hybrid":
            per_layer += mults * d * self.d_ff
        per_layer += 2 * d  # norms
        total = emb + L * per_layer
        if self.family == "hybrid":
            total += attn + mults * d * self.d_ff  # the one shared attention+mlp block
        if self.is_encoder_decoder:
            total += self.encoder_layers * per_layer + L * per_layer
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.num_experts == 0:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        eff = self.moe_d_ff or self.d_ff
        mults = 3 if self.mlp in ("swiglu", "geglu") else 2
        dense_moe = self.num_experts * mults * d * eff
        active_moe = (self.experts_per_token + self.num_shared_experts) * mults * d * eff
        return self.param_count() - L * dense_moe + L * active_moe

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register_config(name: str, full: Callable[[], ModelConfig], smoke: Callable[[], ModelConfig]):
    _REGISTRY[name] = full
    _SMOKE_REGISTRY[name] = smoke


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)

    reg = _SMOKE_REGISTRY if smoke else _REGISTRY
    if name not in reg:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(reg)}")
    return reg[name]()


def list_configs():
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Federation / training configuration (the paper's hyper-parameters)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FederationConfig:
    """Paper §III: M groups, K_m devices each, sampling fraction alpha."""

    num_groups: int = 10  # M
    devices_per_group: int = 8  # K_m (uniform; paper uses 3458/1468/920)
    alpha: float = 0.25  # fraction of devices sampled into A_m
    local_interval: int = 1  # Q
    global_interval: int = 1  # P  (P = Λ·Q)
    # vertical feature split fraction held by the hospital
    hospital_feature_frac: float = 0.5
    non_iid_labels_per_group: int = 2
    # --- robust aggregation (fault-tolerant federation layer) ---
    # how a screened round combines the surviving device towers in eq. (1):
    # "mean" keeps the masked mean over trusted slots; "median"/"trimmed"
    # use the coordinate-wise robust statistic. Groups whose screening
    # passes always take the masked-mean path bit-exactly.
    robust_agg: str = "mean"
    trim_frac: float = 0.1      # per-side trim fraction for "trimmed"
    screen_zmax: float = 8.0    # norm-outlier cut: ||g|| > zmax * median norm

    def __post_init__(self):
        if self.local_interval < 1 or self.global_interval < 1:
            raise ValueError(
                f"intervals must be >= 1, got Q={self.local_interval} P={self.global_interval}")
        if self.global_interval % self.local_interval:
            raise ValueError(
                f"global_interval P={self.global_interval} must be a multiple of "
                f"local_interval Q={self.local_interval} (Λ = P/Q is integral in Alg. 1)")
        if self.robust_agg not in ("mean", "median", "trimmed"):
            raise ValueError(
                f"robust_agg must be mean|median|trimmed, got {self.robust_agg!r}")
        if not 0.0 <= self.trim_frac < 0.5:
            raise ValueError(f"trim_frac must be in [0, 0.5), got {self.trim_frac}")
        if self.screen_zmax <= 1.0:
            raise ValueError(f"screen_zmax must be > 1, got {self.screen_zmax}")

    @property
    def lam(self) -> int:
        return self.global_interval // self.local_interval

    @property
    def sampled_devices(self) -> int:
        return max(1, int(round(self.alpha * self.devices_per_group)))


@dataclass(frozen=True)
class TrainConfig:
    seed: int = 0
    steps: int = 100
    batch_size: int = 32  # per-group mini-batch |ξ_m|
    learning_rate: float = 0.01
    lr_halve_every: int = 0  # T0; 0 disables (paper: decays halved per T0)
    optimizer: str = "sgd"  # sgd | momentum | adam
    weight_decay: float = 0.0
    algorithm: str = "hsgd"  # hsgd | jfl | tdcd | c-hsgd | c-tdcd | centralized
    compression_k: float = 0.0  # top-k fraction for C-* variants (0 = off)
    quantization_bits: int = 0  # b-level quantization (paper: b=128 -> log2(b) bits)
    remat: bool = True


def apply_overrides(cfg, overrides: Dict[str, Any]):
    """Apply ``key=value`` CLI overrides to a dataclass config."""
    valid = {f.name: f.type for f in dataclasses.fields(cfg)}
    kw = {}
    for k, v in overrides.items():
        if k not in valid:
            raise KeyError(f"unknown config field '{k}' for {type(cfg).__name__}")
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            kw[k] = str(v).lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            kw[k] = int(v)
        elif isinstance(cur, float):
            kw[k] = float(v)
        else:
            kw[k] = v
    return dataclasses.replace(cfg, **kw)


def parse_kv_list(items) -> Dict[str, str]:
    """``["key=value", ...]`` -> {key: value} (values stay strings)."""
    out = {}
    for it in items or []:
        if "=" not in it:
            raise ValueError(f"override must be key=value, got {it!r}")
        k, v = it.split("=", 1)
        out[k] = v
    return out

"""Federation / training configuration (the paper's hyper-parameters).

Same fields, defaults and validation errors as ``repro/common/config.py``;
the LLM ``ModelConfig`` registry comes with the LLM slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict


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
    # robust aggregation of the fault-tolerant layer (validated here; the
    # fault path itself comes with a later slice)
    robust_agg: str = "mean"
    trim_frac: float = 0.1
    screen_zmax: float = 8.0

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

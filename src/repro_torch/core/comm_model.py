"""Communication-cost and wall-time models (paper §VI Prop. 1 and §VII-A3).

Pure Python, the formulas of ``repro/core/comm_model.py`` unchanged; the
parameter trees are sized with ``tree_bytes`` (real or meta tensors).

Two link models:
  * WAN  — the paper's e-health network (mobile 110/14 Mbps down/up between
    devices and edge; broadband 204/74 Mbps among edge/hospital/cloud), used
    to reproduce Figs. 4–9 and Table II;
  * ICI  — the TPU-pod adaptation (symmetric ~50 GB/s links), used by the
    roofline (§Roofline) where the same 1/P and 1/Q amortization governs the
    collective term.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.common.config import FederationConfig
from repro_torch.common.pytree import tree_bytes
from repro_torch.core.compression import compressed_bytes

MBIT = 1e6 / 8.0  # bytes per second per Mbps


@dataclass(frozen=True)
class LinkModel:
    dev_up: float  # device -> edge (B/s)
    dev_down: float  # edge -> device
    bb_up: float  # edge/hospital -> cloud
    bb_down: float  # cloud -> edge/hospital


WAN = LinkModel(dev_up=14 * MBIT, dev_down=110 * MBIT, bb_up=74 * MBIT, bb_down=204 * MBIT)
ICI = LinkModel(dev_up=50e9, dev_down=50e9, bb_up=50e9, bb_down=50e9)


@dataclass(frozen=True)
class MessageSizes:
    """Per-event wire sizes (bytes) for one hospital-patient group."""

    theta0: float
    theta1: float
    theta2: float
    z1: float  # hospital -> devices intermediate results (whole mini-batch)
    z2: float  # devices -> hospital
    n_active: int  # |A_m|
    raw_upfront: float = 0.0  # TDCD's raw-data merge


def message_sizes(
    model_params: Dict,
    z1_elements: int,
    z2_elements: int,
    n_active: int,
    compression_k: float = 0.0,
    quant_levels: int = 0,
    raw_upfront: float = 0.0,
    bytes_per_el: int = 4,
) -> MessageSizes:
    t0 = tree_bytes(model_params["theta0"])
    t1 = tree_bytes(model_params["theta1"])
    t2 = tree_bytes(model_params["theta2"])
    if compression_k or quant_levels:
        t0_el = t0 // bytes_per_el
        t0 = compressed_bytes(t0_el, compression_k or 1.0, quant_levels, bytes_per_el)
        z1b = compressed_bytes(z1_elements, compression_k or 1.0, quant_levels, bytes_per_el)
        z2b = compressed_bytes(z2_elements, compression_k or 1.0, quant_levels, bytes_per_el)
    else:
        z1b = z1_elements * bytes_per_el
        z2b = z2_elements * bytes_per_el
    return MessageSizes(t0, t1, t2, z1b, z2b, n_active, raw_upfront)


def comm_cost_per_iteration(sizes: MessageSizes, fed: FederationConfig) -> float:
    """Eq. (19)'s integrand: C(P,Q)/T for a single group, in bytes/iteration.

      C(P,Q) = ( |θ1|/P + (|A||θ2| + |θ0| + |Z1| + |Z2|)/Q ) · M · T
    """
    P, Q = fed.global_interval, fed.local_interval
    per_global = sizes.theta1 / P
    per_local = (sizes.n_active * sizes.theta2 + sizes.theta0 + sizes.z1 + sizes.z2) / Q
    return per_global + per_local


def total_comm_cost(sizes: MessageSizes, fed: FederationConfig, iterations: int) -> float:
    """Total bytes for one group over ``iterations`` steps (+ TDCD upfront)."""
    return comm_cost_per_iteration(sizes, fed) * iterations + sizes.raw_upfront


def per_round_bytes(sizes: MessageSizes, P: int, Q: int, num_groups: int = 1) -> float:
    """Modeled bytes of ONE global round (P iterations of eq. (19)) over all groups.

    This is the quantity the adaptive controller's byte governor charges per
    round when P/Q vary online.
    """
    fed = FederationConfig(local_interval=Q, global_interval=P)
    return comm_cost_per_iteration(sizes, fed) * P * num_groups


def round_time(
    sizes: MessageSizes,
    fed: FederationConfig,
    t_compute: float,
    links: LinkModel = WAN,
) -> float:
    """§VII-A3: t = t_g + (P/Q)(t_l + t_e) + P · t_c for one global round.

    Devices transmit in parallel (time = one device's payload / link speed);
    hospital/cloud payloads aggregate the group's models. Symmetric fleet:
    every device sits on the nominal WAN link and computes at nominal speed —
    the degenerate (tail = 1) case of ``round_time_hetero``.
    """
    return round_time_hetero(sizes, fed, t_compute, links)


def round_time_hetero(
    sizes: MessageSizes,
    fed: FederationConfig,
    t_compute: float,
    links: LinkModel = WAN,
    dev_tail: float = 1.0,
    compute_tail: float = 1.0,
) -> float:
    """§VII-A3 round time under device heterogeneity (straggler tails).

    Every device-parallel event (θ2 local aggregation, ζ exchange legs that
    touch a device link) completes when the SLOWEST sampled device does, so
    those terms scale by ``dev_tail`` — the max latency multiplier over the
    round's cohort (from a seeded trace, see ``core/population.py``).
    ``compute_tail`` scales the P·t_c term the same way (slowest device gates
    each lockstep SGD iteration). Backbone (edge/hospital↔cloud) legs are not
    device-gated and stay at the nominal broadband constants. Tails of 1.0
    reproduce the paper's symmetric model exactly.
    """
    P = fed.global_interval
    lam = fed.lam  # FederationConfig validates P % Q == 0 (no silent flooring)
    # global aggregation: hospital uploads (θ0,θ1,θ2), cloud returns them
    up = sizes.theta0 + sizes.theta1 + sizes.theta2
    t_g = up / links.bb_up + up / links.bb_down
    # local aggregation: each device uploads θ2 (parallel), edge returns θ2
    t_l = sizes.theta2 / links.dev_up + sizes.theta2 / links.dev_down
    # exchange: devices upload ζ2 (their own sample's share, parallel);
    # edge sends θ0 + Z1 down to devices; hospital<->edge over broadband
    z2_per_dev = sizes.z2 / max(sizes.n_active, 1)
    t_e_dev = z2_per_dev / links.dev_up + (sizes.theta0 + sizes.z1) / links.dev_down
    t_e_bb = (sizes.z1 + sizes.z2 + sizes.theta0) / links.bb_up
    return (
        t_g
        + lam * ((t_l + t_e_dev) * dev_tail + t_e_bb)
        + P * t_compute * compute_tail
    )


def time_to_step(
    sizes: MessageSizes,
    fed: FederationConfig,
    t_compute: float,
    steps: int,
    links: LinkModel = WAN,
    include_upfront: bool = True,
) -> float:
    """Wall-clock time after ``steps`` iterations (rounds may be partial)."""
    P = fed.global_interval
    rounds = steps / P
    t = rounds * round_time(sizes, fed, t_compute, links)
    if include_upfront and sizes.raw_upfront:
        t += sizes.raw_upfront / links.bb_up
    return t

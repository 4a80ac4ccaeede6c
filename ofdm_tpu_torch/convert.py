"""Carry a link setup across from the JAX package as plain numpy arrays.

This system has no weights: a link's state is its host setup (channel,
allocation, constellation or adaptive orders), from which ``LinkRunner``
derives the kernel's constant rows.  ``setup_to_arrays`` reads the fields
both packages' ``LinkSetup`` share, so it takes either one without
importing the other; ``setup_from_arrays`` builds the port's ``LinkSetup``
from them.  An lr
link's other parameters are its low-rank factors, which
``lr_factors_from_arrays`` carries across the same way.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ofdm_tpu_torch.config import AdaptiveModulationMode, SimulationConfig
from ofdm_tpu_torch.ops.adaptive import make_adaptive_mapper
from ofdm_tpu_torch.ops.lowrank import LRFactors
from ofdm_tpu_torch.ops.mapping import Constellation
from ofdm_tpu_torch.pipeline import LinkSetup

FIELDS = (
    "taps", "h_freq", "channel_gains", "noise_power", "prefix_length",
    "power_allocation", "water_level", "constellation_orders",
    "num_ofdm_symbols", "bits_per_ofdm_symbol", "total_bits",
)


def setup_to_arrays(setup) -> Dict[str, np.ndarray]:
    """Numpy arrays of a ``LinkSetup`` (JAX package or port).  An adaptive
    setup's mapper follows from its orders (``constellation_orders``) and
    its config; a fixed one carries its constellation."""
    out = {f: np.asarray(getattr(setup, f)) for f in FIELDS if f != "water_level"}
    out["water_level"] = np.asarray(np.nan if setup.water_level is None else setup.water_level)
    if setup.const is None:
        return out
    out["const_table"] = np.asarray(setup.const.table)
    out["const_inv_index"] = np.asarray(setup.const.inv_index)
    out["const_scale"] = np.asarray(setup.const.scale)
    out["const_coding"] = np.asarray(setup.const.coding)
    return out


def setup_from_arrays(cfg: SimulationConfig, arrays: Dict[str, np.ndarray]) -> LinkSetup:
    """The port's ``LinkSetup`` for ``cfg`` from ``setup_to_arrays`` output."""
    wl = float(arrays["water_level"])
    orders = np.asarray(arrays["constellation_orders"], np.int64)
    const = amap = None
    if cfg.adaptive_modulation_mode == AdaptiveModulationMode.CAPACITY_BASED:
        amap = make_adaptive_mapper(cfg.constellation_type.value, orders)
    else:
        const = Constellation(
            kind=cfg.constellation_type.value,
            order=cfg.constellation_order,
            table=np.asarray(arrays["const_table"], np.complex128),
            inv_index=np.asarray(arrays["const_inv_index"], np.int32),
            scale=float(arrays["const_scale"]),
            coding=str(arrays["const_coding"]),
        )
    return LinkSetup(
        cfg=cfg,
        taps=np.asarray(arrays["taps"], np.complex128),
        h_freq=np.asarray(arrays["h_freq"], np.complex128),
        channel_gains=np.asarray(arrays["channel_gains"], np.float64),
        noise_power=float(arrays["noise_power"]),
        prefix_length=int(arrays["prefix_length"]),
        power_allocation=np.asarray(arrays["power_allocation"], np.float64),
        water_level=None if np.isnan(wl) else wl,
        constellation_orders=orders,
        const=const,
        amap=amap,
        num_ofdm_symbols=int(arrays["num_ofdm_symbols"]),
        bits_per_ofdm_symbol=int(arrays["bits_per_ofdm_symbol"]),
        total_bits=int(arrays["total_bits"]),
    )


def lr_factors_from_arrays(d, tail, cr, cp, bnoise: Optional[np.ndarray], pw_scale: float, E: int) -> LRFactors:
    """The port's ``LRFactors`` from the arrays of an ``LRFactors`` (JAX
    package or port), for ``lr_kernel.lr_link(setup, device, factors=...)``."""
    c = lambda a: np.array(a, np.complex128)  # noqa: E731
    return LRFactors(d=c(d), tail=c(tail), cr=c(cr), cp=c(cp),
                     bnoise=None if bnoise is None else c(bnoise), pw_scale=float(pw_scale), E=int(E))

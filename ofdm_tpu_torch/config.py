"""Configuration layer: strategy enums + frozen, hashable simulation config.

The port's own copy of ``ofdm_tpu.config``: same enums, field names,
defaults and validation, so one config describes the same link in both
packages.  Mirrors the semantics of the reference configuration system
(`configuration/enums.py:4-67`, `configuration/models.py:19-151` in the
reference repo); configs are immutable dataclasses that hash by value.

Validation rules replicate the reference pydantic validators:
  * exactly one of ``num_bits`` / ``num_symbols`` (models.py:119-126)
  * ``prefix_length_ratio`` in [0, 2]                (models.py:128-133)
  * min/max constellation order: power of two in [2, 4096] (models.py:135-142)
  * ``desired_symbol_error_rate`` in (0, 0.5)        (models.py:144-151)
"""

from __future__ import annotations

import dataclasses
import json
import os
from enum import Enum
from typing import Optional, Tuple


class ConstellationType(str, Enum):
    QAM = "QAM"
    PSK = "PSK"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


class PrefixType(str, Enum):
    CYCLIC = "CYCLIC"
    ZERO = "ZERO"
    NONE = "NONE"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


class EqualizationMethod(str, Enum):
    ZF = "ZF"
    MMSE = "MMSE"
    NONE = "NONE"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


class ModulationType(str, Enum):
    OFDM = "OFDM"
    SC_OFDM = "SC-OFDM"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


class ChannelType(str, Enum):
    FLAT = "FLAT"
    CUSTOM = "CUSTOM"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


class NoiseType(str, Enum):
    AWGN = "AWGN"
    NONE = "NONE"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


class PowerAllocationType(str, Enum):
    UNIFORM = "UNIFORM"
    WATERFILLING = "WATERFILLING"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


class AdaptiveModulationMode(str, Enum):
    FIXED = "FIXED"
    CAPACITY_BASED = "CAPACITY_BASED"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


def _is_power_of_two(v: int) -> bool:
    return v >= 1 and (v & (v - 1)) == 0


def _load_json(file_path: str) -> dict:
    if not os.path.exists(file_path):
        raise FileNotFoundError(f"Configuration file not found: {file_path}")
    with open(file_path, "r", encoding="utf-8") as fh:
        return json.load(fh)


@dataclasses.dataclass(frozen=True)
class Settings:
    """Project-level settings (reference `Settings`, configuration/models.py:31-39)."""

    project_name: str
    version: str
    debug: bool = False

    @classmethod
    def from_json(cls, file_path: str) -> "Settings":
        data = _load_json(file_path)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    """One fully-specified simulation (all strategy axes + sizes).

    Field names and defaults follow the reference `SimulationSettings`
    (configuration/models.py:42-151) with the reference's JSON key names kept
    in :meth:`from_json` for drop-in config-file compatibility.
    """

    # --- sizes -----------------------------------------------------------
    num_subcarriers: int = 64
    num_bits: Optional[int] = None
    num_symbols: Optional[int] = None

    # --- strategy axes ---------------------------------------------------
    constellation_order: int = 16
    constellation_type: ConstellationType = ConstellationType.QAM
    modulation_type: ModulationType = ModulationType.OFDM
    prefix_type: PrefixType = PrefixType.CYCLIC
    prefix_length_ratio: float = 1.0
    equalization_method: EqualizationMethod = EqualizationMethod.MMSE
    noise_type: NoiseType = NoiseType.AWGN
    power_allocation_type: PowerAllocationType = PowerAllocationType.UNIFORM
    adaptive_modulation_mode: AdaptiveModulationMode = AdaptiveModulationMode.FIXED

    # --- adaptive-modulation knobs ----------------------------------------
    min_constellation_order: int = 4
    max_constellation_order: int = 256
    desired_symbol_error_rate: float = 1e-3

    # --- channel -----------------------------------------------------------
    channel_type: ChannelType = ChannelType.FLAT
    # Name of a built-in channel model (ofdm_tpu_torch.models.channels) or a path to
    # a `.npy` complex impulse response; None -> reference's hardcoded 4-tap
    # default multipath (simulation/models.py:237-245).
    channel_model: Optional[str] = None

    # --- link-level SNR (one point; sweeps carry a grid of configs) --------
    snr_db: float = 20.0

    # --- execution knobs (no reference analog) ------------------------------
    # The JAX package's execution knobs, kept so one config file drives both
    # packages.  The port reads symbols_per_chunk (OFDM symbols per kernel
    # launch; 0 = one chunk), papr_stride (the PAPR statistic runs on every
    # papr_stride-th tile of a chunk; 0 = auto = 32, 1 = every tile), the
    # two power switches, hotpath, and matmul_passes only for the JAX
    # planner's tile rule (link_kernel.selected_passes).  hotpath "auto" or
    # "pallas" runs a link on its chunk kernel where one takes it; any other
    # value ("xla", "matmul", ...) sends it to the eager chain, as the JAX
    # package sends it to chunk_body (pipeline.kernel_mode).  dtype and
    # engine select JAX/TPU paths: the port runs f32 / complex64 and ignores
    # them.
    dtype: str = "complex64"
    engine: str = "auto"
    symbols_per_chunk: int = 0
    # Apply sqrt(power_allocation) at TX (the reference computes but does NOT
    # apply it in the main path — simulation/models.py:508).
    apply_power_allocation: bool = False
    # Normalize demodulated symbols to unit average power before demapping
    # (commented out in the reference main path, simulation/models.py:574-586).
    normalize_before_demap: bool = False
    hotpath: str = "auto"
    matmul_passes: object = "auto"
    papr_stride: int = 0

    # Fields declared as str-Enums accept plain strings ("WATERFILLING") for
    # ergonomic direct construction; __post_init__ coerces them so downstream
    # `.name` / identity checks always see the enum member.
    _ENUM_FIELDS = {
        "constellation_type": ConstellationType,
        "modulation_type": ModulationType,
        "prefix_type": PrefixType,
        "equalization_method": EqualizationMethod,
        "noise_type": NoiseType,
        "power_allocation_type": PowerAllocationType,
        "adaptive_modulation_mode": AdaptiveModulationMode,
        "channel_type": ChannelType,
    }

    def __post_init__(self) -> None:
        for fname, enum_cls in self._ENUM_FIELDS.items():
            v = getattr(self, fname)
            if not isinstance(v, enum_cls):
                try:
                    member = enum_cls(v)  # by value ("SC-OFDM")
                except ValueError:
                    try:
                        member = enum_cls[v]  # by name ("SC_OFDM")
                    except KeyError:
                        raise ValueError(
                            f"{fname}={v!r} is not one of "
                            f"{[m.value for m in enum_cls]}"
                        ) from None
                object.__setattr__(self, fname, member)
        if self.matmul_passes not in ("auto", 1, 3):
            raise ValueError("matmul_passes must be 'auto', 1 or 3.")
        if self.num_bits is None and self.num_symbols is None:
            raise ValueError("Either num_bits or num_symbols must be specified.")
        if self.num_bits is not None and self.num_symbols is not None:
            raise ValueError("Only one of num_bits or num_symbols should be specified.")
        if not 0.0 <= self.prefix_length_ratio <= 2.0:
            raise ValueError("prefix_length_ratio must be between 0 and 2 (inclusive).")
        for v in (self.min_constellation_order, self.max_constellation_order):
            if v < 2 or v > 4096:
                raise ValueError("Constellation order must be between 2 and 4096.")
            if not _is_power_of_two(v):
                raise ValueError(f"Constellation order must be a power of 2, got {v}.")
        if not 0.0 < self.desired_symbol_error_rate < 0.5:
            raise ValueError("desired_symbol_error_rate must be in (0, 0.5).")
        if self.num_subcarriers <= 0:
            raise ValueError("num_subcarriers must be positive.")
        if not _is_power_of_two(self.constellation_order):
            raise ValueError("constellation_order must be a power of 2.")
        if self.papr_stride < 0 or (
            self.papr_stride > 1 and not _is_power_of_two(self.papr_stride)
        ):
            raise ValueError("papr_stride must be 0 (auto) or a power of 2.")

    # -- reference-compatible JSON loading ---------------------------------
    @classmethod
    def from_json(cls, file_path: str) -> Tuple["SimulationConfig", ...]:
        """Load a reference-format JSON settings file.

        The reference fans one settings file out into one `Simulation` per SNR
        value (simulation/models.py:190-212); we return a tuple of configs,
        one per entry of ``signal_noise_ratios``.
        """
        data = _load_json(file_path)
        return cls.from_reference_dict(data)

    @classmethod
    def from_reference_dict(cls, data: dict) -> Tuple["SimulationConfig", ...]:
        snrs = data.get("signal_noise_ratios", [data.get("snr_db", 20.0)])
        channel_type = ChannelType(data.get("channel_type", "FLAT"))
        channel_model = data.get("channel_model_path") or None
        common = dict(
            num_subcarriers=data.get("num_bands", 64),
            num_bits=data.get("num_bits"),
            num_symbols=data.get("num_symbols"),
            constellation_order=data.get("constellation_order", 16),
            constellation_type=ConstellationType(data.get("constellation_type", "PSK")),
            modulation_type=ModulationType(data.get("modulation_type", "OFDM")),
            prefix_type=PrefixType(data.get("prefix_type", "CYCLIC")),
            prefix_length_ratio=data.get("prefix_length_ratio", 0.25),
            equalization_method=EqualizationMethod(data.get("equalization_method", "MMSE")),
            noise_type=NoiseType(data.get("noise_type", "AWGN")),
            power_allocation_type=PowerAllocationType(
                data.get("power_allocation_type", "UNIFORM")
            ),
            adaptive_modulation_mode=AdaptiveModulationMode(
                data.get("adaptive_modulation_mode", "FIXED")
            ),
            min_constellation_order=data.get("min_constellation_order", 4),
            max_constellation_order=data.get("max_constellation_order", 256),
            desired_symbol_error_rate=data.get("desired_symbol_error_rate", 1e-3),
            channel_type=channel_type,
            channel_model=channel_model if channel_type == ChannelType.CUSTOM else None,
        )
        return tuple(cls(snr_db=float(snr), **common) for snr in snrs)

    # -- convenience -------------------------------------------------------
    @property
    def bits_per_symbol(self) -> int:
        return self.constellation_order.bit_length() - 1

    def replace(self, **kw) -> "SimulationConfig":
        return dataclasses.replace(self, **kw)

    @property
    def title(self) -> str:
        """Reference plot title (simulation/models.py:435-438)."""
        acr = {PrefixType.CYCLIC: "CP", PrefixType.ZERO: "ZP", PrefixType.NONE: ""}[
            self.prefix_type
        ]
        return f"{acr}-{self.modulation_type.name}-{self.equalization_method.name}"

    @property
    def subtitle(self) -> str:
        """Reference plot subtitle (simulation/models.py:439-442)."""
        return (
            f"{self.constellation_order}{self.constellation_type.name}-"
            f"SNR{self.snr_db}dB-{self.power_allocation_type.name}"
        )

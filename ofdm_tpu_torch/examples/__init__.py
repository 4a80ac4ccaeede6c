"""The JAX package's examples, notebook and ``plot_constellations.py`` on the port.

Each module has ``main(argv=None)`` and runs as
``python -m ofdm_tpu_torch.examples.<name>``, with the JAX script's
defaults and printed lines.  Where the JAX script keys its draws with
``jax.random.PRNGKey(k)`` the module takes ``--seed`` (default k); where it
runs a link it takes ``--device`` (default: the card, ``cpu`` for the
kernels' plain versions); where it has a fixed size it takes one option
for that size, with the script's value as its default.  ``main`` returns
the records of the links it ran (``record``; ``parity_report`` returns its
exit status).  No module imports more than the standard library at
import time.
"""

from __future__ import annotations

import os
from typing import Any, Dict

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def repo_file(path: str) -> str:
    """``path`` where it exists from the working directory, else under the repo root."""
    return path if os.path.exists(path) else os.path.join(REPO_ROOT, path)


def add_link_options(parser, seed: int = 0) -> None:
    """``--seed`` and ``--device``, the options of every example that runs a link."""
    parser.add_argument("--seed", type=int, default=seed,
                        help=f"seeds every random draw (the JAX script's PRNGKey({seed}))")
    parser.add_argument("--device", default=None, help="cuda (default: the card) or cpu")


def record(label: str, route: str, r: Dict[str, Any]) -> Dict[str, Any]:
    """One link's record: its label, route (``pipeline.kernel_mode``, or the
    chain's name), where it ran, its bit errors, bits, BER and OFDM syms/s."""
    return {"label": label, "kernel_mode": route, "hotpath_used": r["hotpath_used"],
            "bit_errors": int(r["bit_errors"]), "total_bits": int(r["total_bits"]),
            "bit_error_rate": float(r["bit_error_rate"]), "ofdm_symbols_per_s": float(r["ofdm_symbols_per_s"])}


def link_record(label: str, cfg, r: Dict[str, Any], channel_ir=None) -> Dict[str, Any]:
    """``record`` of a ``LinkRunner`` result, its route from ``prepare(cfg)``."""
    from ofdm_tpu_torch.pipeline import kernel_mode, prepare

    return record(label, kernel_mode(prepare(cfg, channel_ir)), r)


def save_figure(fig, path: str, dpi: int) -> None:
    """Write ``fig`` (a matplotlib figure or a ``PilFigure``) as a PNG and close it."""
    from ofdm_tpu_torch.utils import visualization as vis

    fig.savefig(path, dpi=dpi)
    if not isinstance(fig, vis.PilFigure):
        vis._pyplot().close(fig)

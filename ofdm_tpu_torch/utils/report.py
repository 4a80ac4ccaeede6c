"""Result management: CSV upsert, structured image names, BER plots.

The port's own copy of ``ofdm_tpu.utils.report`` (the reference's
``ResultsManager``, main.py:19-194): the same CSV schema and upsert by
(simulation_name, snr_db), which is the sweep's resume
(``completed_points``); the same PNG filename grammar
``{CP|ZP}-{OFDM|SC-OFDM}-{ZF|MMSE}-{order}{QAM|PSK}-{WF|UNIFORM}-SNR{x_y}dB.png``
and per-channel image directories, mirrored into ``docs/figures``.  The
CSV is written with the standard library (floats as their shortest
repr, as pandas writes them).  Figures are drawn with matplotlib in the
JAX package's style (``BER_CURVE_STYLE``, the port's
``utils.visualization``), or with PIL where matplotlib is not installed.
"""

from __future__ import annotations

import csv
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np

from ofdm_tpu_torch.utils import visualization as vis

CSV_COLUMNS = ("simulation_name", "snr_db", "bit_error_rate")
# The BER curve's look (ofdm_tpu/utils/report.py, transcribed from the
# reference's rendered output, main.py:146-194).
BER_CURVE_STYLE: Dict[str, Any] = {
    "figsize": (10, 6),
    "line": {"marker": "o", "linestyle": "-", "color": "blue", "label": "BER vs SNR"},
    "xlabel": ("SNR (dB)", 12),
    "ylabel": ("Bit Error Rate (BER)", 12),
    "title": ("BER vs SNR Performance", 14),
    "grid": {"which": "both", "linestyle": "--", "linewidth": 0.5, "alpha": 0.7},
    "legend_fontsize": 11,
    "dpi": 150,
}


def _save_ber_curve(path: Path, snrs, bers) -> None:
    if not vis.have_matplotlib():
        vis.pil_ber_curve(path, snrs, bers, BER_CURVE_STYLE["title"][0])
        return
    plt = vis._pyplot()
    style = BER_CURVE_STYLE
    fig, ax = plt.subplots(figsize=style["figsize"])
    ax.semilogy(snrs, bers, **style["line"])
    for setter, key in ((ax.set_xlabel, "xlabel"), (ax.set_ylabel, "ylabel")):
        text, size = style[key]
        setter(text, fontsize=size)
    title, title_size = style["title"]
    ax.set_title(title, fontsize=title_size, fontweight="bold")
    ax.grid(True, **style["grid"])
    ax.legend(fontsize=style["legend_fontsize"])
    fig.tight_layout()
    fig.savefig(path, dpi=style["dpi"])
    plt.close(fig)


class ResultsManager:
    """CSV and image output of a sweep (reference main.py:19-194 semantics)."""

    def __init__(
        self,
        results_dir: str = "results",
        images_dir: str = "images",
        channel_name: str = "default",
        doc_figures_dir: Union[str, Path, None] = "docs/figures",
    ):
        self.results_dir = Path(results_dir)
        self.channel_name = channel_name
        self.images_dir = Path(images_dir) / channel_name
        self.csv_path = self.results_dir / "ber_results.csv"
        self.doc_figures_dir: Optional[Path] = Path(doc_figures_dir) if doc_figures_dir else None
        self.doc_channel_dir: Optional[Path] = None

        self.results_dir.mkdir(parents=True, exist_ok=True)
        self.images_dir.mkdir(parents=True, exist_ok=True)
        if self.doc_figures_dir:
            self.doc_channel_dir = self.doc_figures_dir / self.channel_name
            self.doc_channel_dir.mkdir(parents=True, exist_ok=True)

    # -- docs mirroring (main.py:53-67) -------------------------------------
    def _mirror_to_docs(self, source_path: Path) -> Optional[Path]:
        if not self.doc_channel_dir or not source_path.exists():
            return None
        try:
            relative = source_path.relative_to(self.images_dir)
        except ValueError:
            relative = Path(source_path.name)
        destination = self.doc_channel_dir / relative
        destination.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(source_path, destination)
        return destination

    # -- CSV upsert (main.py:69-101) -----------------------------------------
    def _rows(self) -> List[List[Any]]:
        if not self.csv_path.exists():
            return []
        with open(self.csv_path, newline="") as fh:
            reader = csv.reader(fh)
            next(reader, None)
            return [[name, float(snr), float(ber)] for name, snr, ber in reader]

    def update_ber_csv(self, simulation_name: str, snr_db: float, bit_error_rate: float) -> None:
        rows = self._rows()
        hits = [r for r in rows if r[0] == simulation_name and r[1] == float(snr_db)]
        for r in hits:
            r[2] = float(bit_error_rate)
        if not hits:
            rows.append([simulation_name, float(snr_db), float(bit_error_rate)])
        with open(self.csv_path, "w", newline="") as fh:
            writer = csv.writer(fh, lineterminator="\n")
            writer.writerow(CSV_COLUMNS)
            writer.writerows([name, repr(snr), repr(ber)] for name, snr, ber in rows)

    def completed_points(self, simulation_name: str) -> List[float]:
        """SNRs already recorded for a simulation: grid-level resume."""
        return [snr for name, snr, _ in self._rows() if name == simulation_name]

    # -- structured image name (main.py:129-144) -------------------------------
    @staticmethod
    def image_filename(result: Dict[str, Any], suffix: str = "") -> str:
        snr_str = f"{result['snr_db']:.1f}".replace(".", "_")
        tail = suffix if suffix else f"SNR{snr_str}dB"
        return (
            f"{result.get('prefix_acronym', 'NONE')}-"
            f"{result.get('modulator_type', 'OFDM')}-"
            f"{result.get('equalizator_type', 'NONE')}-"
            f"{result.get('constellation_order', 16)}"
            f"{result.get('constellation_scheme', 'QAM')}-"
            f"{result.get('power_allocation_acronym', 'UNIFORM')}-"
            f"{tail}.png"
        )

    # -- constellation plot (simulation/models.py:629-796 layouts) -------------
    def save_constellation_plot(self, result: Dict[str, Any], ideal_points: np.ndarray) -> Optional[Path]:
        received = result.get("received_symbols")
        if received is None:
            return None
        filepath = self.images_dir / self.image_filename(result)
        args = (np.asarray(received), np.asarray(ideal_points), result["bit_error_rate"], result["snr_db"],
                result["papr_db"])
        is_adaptive = result.get("adaptive_modulation_mode") == "CAPACITY_BASED"
        if not vis.have_matplotlib():
            vis.pil_constellation(filepath, *args, result.get("title", ""))
        else:
            plt = vis._pyplot()
            if is_adaptive:
                fig = vis.plot_combined_constellation_analysis(
                    np.asarray(result["constellation_order_per_subcarrier"]), args[0], args[1],
                    result["num_subcarriers"], *args[2:])
            else:
                fig, ax = plt.subplots(figsize=(8, 8))
                vis._constellation_scatter(ax, *args, result.get("title", ""))
                fig.tight_layout()
            fig.savefig(filepath, format="png")
            plt.close(fig)
        self._mirror_to_docs(filepath)
        return filepath

    # -- BER-vs-SNR curve (main.py:146-194) -------------------------------------
    def plot_ber_vs_snr(self, results: List[Dict[str, Any]]) -> Path:
        bers = [r["bit_error_rate"] for r in results if "bit_error_rate" in r]
        snrs = [r["snr_db"] for r in results if "snr_db" in r]
        if not bers or not snrs:
            return self.images_dir / "ber_vs_snr.png"
        filepath = self.images_dir / self.image_filename(results[0], suffix="BER_vs_SNR")
        _save_ber_curve(filepath, snrs, bers)
        self._mirror_to_docs(filepath)
        return filepath

    # -- streaming hook for run_sweep -------------------------------------------
    def record(self, result: Dict[str, Any]) -> None:
        """Upsert one completed point (the checkpoint of a resumable sweep)."""
        name = result.get("title", "unknown").replace(" ", "_")
        self.update_ber_csv(name, result["snr_db"], result["bit_error_rate"])

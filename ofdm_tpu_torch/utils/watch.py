"""Live BER-plot watcher: re-render the curves whenever the CSV changes.

The port's ``ofdm_tpu.utils.watch`` (the reference's separate-process plot
refresher, ``update_ber_vs_snr_plot.py:13-101``): polls the results CSV's
mtime every ``--interval`` seconds and re-renders a semilogy plot with one
curve per simulation; ``--mode clear`` resets the CSV.  The CSV is read
with the standard library (the CSV of ``utils/report.py``); the plot is
drawn with matplotlib, or with PIL where matplotlib is missing.

Usage:
    python -m ofdm_tpu_torch.utils.watch [--results results/ber_results.csv]
                                         [--output results/ber_vs_snr_live.png]
                                         [--mode update|clear] [--interval 1.0]
                                         [--once]
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from typing import Dict, List, Optional, Tuple

from ofdm_tpu_torch.utils import visualization as vis
from ofdm_tpu_torch.utils.report import CSV_COLUMNS


def read_series(csv_path: str) -> Dict[str, Tuple[List[float], List[float]]]:
    """{simulation name: (snrs, bers)}, names sorted, each sorted by SNR."""
    groups: Dict[str, List[Tuple[float, float]]] = {}
    with open(csv_path, newline="") as fh:
        for row in csv.DictReader(fh):
            groups.setdefault(row["simulation_name"], []).append((float(row["snr_db"]), float(row["bit_error_rate"])))
    out = {}
    for name in sorted(groups):
        pts = sorted(groups[name], key=lambda p: p[0])
        out[name] = ([p[0] for p in pts], [p[1] for p in pts])
    return out


def render_ber_plot(csv_path: str, output_path: str) -> bool:
    """Render the grouped semilogy BER plot; returns True if rendered."""
    if not os.path.exists(csv_path):
        return False
    series = read_series(csv_path)
    if not series:
        return False
    if not vis.have_matplotlib():
        vis.pil_ber_curves(output_path, series, "BER vs SNR (live)", size=(1500, 900))
        return True
    plt = vis._pyplot()
    plt.figure(figsize=(10, 6))
    for name, (snrs, bers) in series.items():
        plt.semilogy(snrs, bers, marker="o", label=name)
    plt.xlabel("SNR (dB)")
    plt.ylabel("Bit Error Rate (BER)")
    plt.title("BER vs SNR (live)")
    plt.grid(True, which="both", linestyle="--", linewidth=0.5, alpha=0.7)
    plt.legend(fontsize=9)
    plt.tight_layout()
    plt.savefig(output_path, dpi=150)
    plt.close()
    return True


def watch(csv_path: str, output_path: str, interval: float = 1.0, once: bool = False) -> None:
    """Poll the CSV mtime; re-render on change (update_ber_vs_snr_plot.py:13-63)."""
    last_mtime = 0.0
    while True:
        try:
            if os.path.exists(csv_path):
                mtime = os.path.getmtime(csv_path)
                if mtime != last_mtime:
                    if render_ber_plot(csv_path, output_path):
                        print(f"updated {output_path}")
                    last_mtime = mtime
        except Exception as exc:  # keep watching through transient IO races
            print(f"watcher retry: {exc}")
        if once:
            return
        time.sleep(interval)


def clear_results_file(csv_path: str) -> None:
    """Reset the CSV to headers only (update_ber_vs_snr_plot.py:65-81)."""
    with open(csv_path, "w", newline="") as fh:
        csv.writer(fh, lineterminator="\n").writerow(CSV_COLUMNS)
    print(f"cleared {csv_path}")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="BER vs SNR Plot Updater")
    parser.add_argument("--results", default="results/ber_results.csv")
    parser.add_argument("--output", default="results/ber_vs_snr_live.png")
    parser.add_argument("--mode", choices=["update", "clear"], default="update")
    parser.add_argument("--interval", type=float, default=1.0)
    parser.add_argument("--once", action="store_true", help="render once and exit")
    args = parser.parse_args(argv)
    if args.mode == "clear":
        clear_results_file(args.results)
        return 0
    watch(args.results, args.output, args.interval, once=args.once)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())

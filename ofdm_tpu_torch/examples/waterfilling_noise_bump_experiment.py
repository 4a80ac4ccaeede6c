"""Water-filling robustness experiment with colored noise bumps.

The port's examples/waterfilling_noise_bump_experiment.py (the reference's
examples/waterfilling_noise_bump_experiment.py, BASELINE configs[3]); the
study itself is ``ofdm_tpu_torch.experiments.noise_bump``.  Writes the BER
curves, the 21 per-point constellation diagrams and the comparison figure
(PIL where matplotlib is missing) and the CSV summaries in the reference's
layout under images/ and results/.  Each point's BER comes from the fused
campaign on the card (2^24 OFDM symbols a point through the chunk kernel
with the study's stages) and from the small-batch link on the CPU.

Run:  python -m ofdm_tpu_torch.examples.waterfilling_noise_bump_experiment
          [--num-ofdm-symbols N] [--device cpu]
"""

from __future__ import annotations

import argparse

from ofdm_tpu_torch.examples import record


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-ofdm-symbols", type=int, default=2048,
                   help="OFDM symbols a point of the small-batch link (the plots; the BER on the CPU)")
    p.add_argument("--device", default=None, help="cuda (default: the card) or cpu")
    args = p.parse_args(argv)

    from ofdm_tpu_torch.experiments import noise_bump as nb
    from ofdm_tpu_torch.pipeline import kernel_mode, prepare

    snrs = (0, 5, 10, 15, 20, 25, 30)
    results = nb.run_noise_bump_experiment(snr_values=snrs, num_ofdm_symbols=args.num_ofdm_symbols,
                                           save_plots=True, device=args.device)
    print("\nBER summary (SNR 0..30 dB):")
    for name, bers in results.items():
        print(f"  {name}: " + " ".join(f"{b:.3e}" for b in bers))

    fused = nb.default_fused_symbols(args.device)
    symbols = fused or args.num_ofdm_symbols
    route = kernel_mode(prepare(nb.fused_config(fused, 64, 64, "Lin-Phoong_P2"))) if fused else "small-batch link"
    bits = symbols * 64 * 6
    on_card = args.device is None or str(args.device).startswith("cuda")
    return [record(f"{s.key}_{snr}db", route, {
        "hotpath_used": "cuda" if on_card else "torch", "bit_errors": round(ber * bits), "total_bits": bits,
        "bit_error_rate": ber, "ofdm_symbols_per_s": float("nan")})
        for s in nb.SCENARIOS for snr, ber in zip(snrs, results[s.name])]


if __name__ == "__main__":
    main()

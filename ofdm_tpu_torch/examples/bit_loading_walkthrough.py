"""Bit loading walkthrough: M-QAM / M-PSK adaptive OFDM, step by step.

The port's examples/bit_loading_walkthrough.py (the script form of the
reference's notebook/bit-loading.ipynb): given a power budget P, N
subcarriers, a global SNR and a target symbol error rate, derive the
waterfilling power allocation, the per-subcarrier SNRs and Shannon
capacities and the gap-function constellation orders, then run the
adaptive link end to end from the bit-level ops on ``--device`` (K4 draws
the bits, K5 the channel's AWGN) and plot the order-coloured
constellation.

The derivation chain (notebook cells 5-11; math in its closing cell):

    SNR_lin   = 10^(SNR_dB/10)
    I         = P / SNR_lin                      (total noise power)
    P_k       = waterfilling(P, |H_k|^2, I)      (power per subcarrier)
    gamma_k   = P_k |H_k|^2 / I                  (per-subcarrier SNR)
    C_k       = log2(1 + gamma_k)                (capacity, bits/symbol)
    b_k       = round(log2(1 + gamma_k / Gamma)) (gap function, QAM: even)
    order_k   = 2^b_k                            (0 = subcarrier off)

where Gamma = (1/3) Qinv(SER/4)^2 is the QAM SNR gap
(constellation/models.py:297-321 in the reference; ops/mapping.py here).

Run:  python -m ofdm_tpu_torch.examples.bit_loading_walkthrough [--num-ofdm-symbols N]
          [--out DIR] [--psk] [--seed S] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

from ofdm_tpu_torch.examples import add_link_options, record, save_figure


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-ofdm-symbols", type=int, default=10_000 // 64)
    p.add_argument("--total-power", type=float, default=1.0)
    p.add_argument("--num-subcarriers", type=int, default=64)
    p.add_argument("--snr-db", type=float, default=20.0)
    p.add_argument("--ser", type=float, default=1e-3)
    p.add_argument("--channel", default="Lin-Phoong_P2")
    p.add_argument("--psk", action="store_true", help="PSK instead of QAM")
    p.add_argument("--out", default=None, help="write plots to this directory")
    add_link_options(p)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ofdm_tpu_torch.config import EqualizationMethod, PrefixType
    from ofdm_tpu_torch.models import channels as chm
    from ofdm_tpu_torch.ops import adaptive as ad
    from ofdm_tpu_torch.ops import allocate as al
    from ofdm_tpu_torch.ops import bits as bi
    from ofdm_tpu_torch.ops import channel as ch
    from ofdm_tpu_torch.ops import equalize as eq
    from ofdm_tpu_torch.ops import framing
    from ofdm_tpu_torch.ops import mapping as mp
    from ofdm_tpu_torch.ops import metrics
    from ofdm_tpu_torch.ops import ofdm, prng

    device = torch.device("cuda" if args.device is None else args.device)
    kind = "PSK" if args.psk else "QAM"
    n_sc = args.num_subcarriers
    total_power = args.total_power

    # -- Step 1: SNR and noise power (notebook cells 5-6) --------------------
    snr_linear = 10.0 ** (args.snr_db / 10.0)
    noise_power = total_power / snr_linear
    print(f"SNR: {args.snr_db} dB = {snr_linear:.1f} linear")
    print(f"Noise power I = P/SNR = {noise_power:.6f} W")

    # -- Step 2: channel frequency response and gains (cell 7) ---------------
    taps = chm.normalize_impulse_response(chm.get_channel(args.channel))
    h_freq = chm.channel_frequency_response(taps, n_sc)
    gains = chm.channel_gains(taps, n_sc)
    print(f"Channel '{args.channel}': {len(taps)} taps, order {len(taps) - 1}")
    print(f"Gains |H_k|^2: min {gains.min():.4f}, max {gains.max():.4f}")

    # -- Step 3: waterfilling power allocation (cell 8) ----------------------
    power = al.waterfilling(total_power, gains, noise_power)
    mu = al.water_level(power, gains, noise_power)
    assert np.isclose(power.sum(), total_power), "budget must be conserved"
    print(f"Waterfilling: water level mu = {mu:.6f}, "
          f"{int((power > 1e-10).sum())}/{n_sc} subcarriers powered")

    # -- Step 4: per-subcarrier SNR and capacity (cells 9-10) ----------------
    # The noise each subcarrier sees is the spectral density N0 = I / (N*BW)
    # (notebook cell 9, BW = 1), not the whole-band noise power.
    n0 = noise_power / n_sc
    print(f"Noise spectral power density N0 = I/N = {n0:.3e} W/Hz")
    snr_per_sc = power * gains / n0
    cap_per_sc = al.capacity_per_subcarrier(power, gains, n0)
    stats = al.compare_allocations(al.uniform(total_power, n_sc), power, gains, n0)
    print(f"Capacity: {stats['waterfilling_capacity']:.4f} bits/use "
          f"(uniform {stats['uniform_capacity']:.4f}, "
          f"+{stats['capacity_gain_percent']:.2f}%)")

    # -- Step 5: gap-function bit loading (cell 11) ---------------------------
    orders = mp.bit_loading_orders(kind, args.ser, snr_per_sc)
    mapper = ad.make_adaptive_mapper(kind, orders)
    total_bits, bits_per_sc = ad.calculate_requirements(orders, args.num_ofdm_symbols)
    print(f"Constellation orders ({mapper.name}):")
    print("  " + " ".join(str(int(o)) for o in orders))
    print(f"Bits per OFDM symbol: {mapper.bits_per_ofdm_symbol} "
          f"(Shannon bound {cap_per_sc.sum():.1f})")
    print(f"Total bits for {args.num_ofdm_symbols} OFDM symbols: {total_bits}")

    # -- Step 6: TX — bits -> symbols -> scaled -> OFDM (cells 12-14) --------
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    key = prng.key_words(args.seed)
    tx_bits = bi.random_bits(prng.fold_in(key, 0), (args.num_ofdm_symbols, mapper.bits_per_ofdm_symbol), device)
    tx_symbols, tx_idx = ad.encode(tx_bits, mapper)            # (B, N)
    sqrt_power = torch.tensor(power, dtype=torch.float32, device=device).sqrt()
    scaled = tx_symbols * sqrt_power[None, :]
    tx_power = float(ch.mean_abs2(scaled) * n_sc)
    print(f"TX power after sqrt(P_k) scaling: {tx_power:.3f} W "
          f"(budget {total_power})")

    prefix_len = len(taps) - 1  # CP absorbs the full channel order
    blocks = ofdm.ofdm_modulate(scaled, n_sc, PrefixType.CYCLIC, prefix_len)
    pwr = blocks.real * blocks.real + blocks.imag * blocks.imag
    papr_db = float(metrics.papr_db(pwr.max(), pwr.sum(), pwr.numel()))
    print(f"PAPR of the OFDM time signal: {papr_db:.2f} dB")

    # -- Step 7: channel (cell 15) --------------------------------------------
    z = prng.normal_planes(key, 0, args.num_ofdm_symbols, n_sc + prefix_len, prng.AWGN_STREAM, device)
    rx_blocks, _ = ch.transmit(blocks, torch.tensor(taps, dtype=torch.complex64, device=device), args.snr_db, z=z)

    # -- Step 8: RX — demodulate, equalize, compensate, decode (cells 16-19) --
    rx_freq = ofdm.ofdm_demodulate_to_freq(rx_blocks, n_sc, PrefixType.CYCLIC, prefix_len)
    equalized = eq.equalize(rx_freq, torch.tensor(h_freq, dtype=torch.complex64, device=device),
                            EqualizationMethod.MMSE, args.snr_db)
    # Undo the TX power scaling per subcarrier before hard decisions
    # (the notebook normalizes to unit power; 1/sqrt(P_k) with a guard is
    # the per-subcarrier form the noise-bump experiment uses).
    comp = torch.where(sqrt_power > 1e-10, 1.0 / sqrt_power.clamp_min(1e-10), torch.zeros_like(sqrt_power))
    rx_symbols = equalized * comp[None, :]
    rx_bits, rx_idx = ad.decode(rx_symbols, mapper)

    # -- Step 9: metrics (cell 19) --------------------------------------------
    errors = int(metrics.bit_errors(tx_bits, rx_bits))
    ber = errors / tx_bits.numel()
    active = torch.as_tensor(np.asarray(mapper.active), device=device)
    ser = float((tx_idx != rx_idx)[:, active].float().mean())
    seconds = time.perf_counter() - t0
    print(f"BER: {ber:.6f}   SER: {ser:.6f} "
          f"(target SER {args.ser:g} at the gap-function design point)")

    # -- Step 10: order-colored constellation (cell 20) -----------------------
    if args.out:
        from ofdm_tpu_torch.utils.visualization import (
            plot_adaptive_constellation_diagram,
            plot_water_level_diagram,
        )

        os.makedirs(args.out, exist_ok=True)
        fig = plot_adaptive_constellation_diagram(
            received_symbols=framing.to_serial(rx_symbols).cpu().numpy().astype(np.complex128),
            constellation_orders=orders,
            constellation_title=kind,
            num_subcarriers=n_sc,
            ber=ber,
            ser=ser,
            snr_db=args.snr_db,
            papr_db=papr_db,
        )
        path = os.path.join(args.out, "bit_loading_constellation.png")
        save_figure(fig, path, 100)
        path2 = os.path.join(args.out, "bit_loading_water_level.png")
        save_figure(plot_water_level_diagram(power, gains, noise_power, mu), path2, 100)
        print(f"Plots: {path}, {path2}")
    return [record("bit_loading_walkthrough", "bit-level ops", {
        "hotpath_used": "cuda" if device.type == "cuda" else "torch", "bit_errors": errors,
        "total_bits": tx_bits.numel(), "bit_error_rate": ber,
        "ofdm_symbols_per_s": args.num_ofdm_symbols / seconds})]


if __name__ == "__main__":
    main()

"""Overview: the full adaptive bit-loading pipeline, built by hand from ops.

The port's examples/overview.py (the reference's examples/overview.py, its
most complete manual walk-through, :50-300): waterfilling -> gap-function
bit loading -> adaptive mapping -> OFDM over a multipath channel ->
per-subcarrier normalization -> demapping -> BER, assembled step by step
from the public ops so you can see every stage.  The bits come from K4
(``bits.random_bits``), the channel's AWGN from K5 (``prng.normal_planes``
into ``channel.transmit``); the packaged pipeline runs the same stages in
one chunk kernel.

Run:  python -m ofdm_tpu_torch.examples.overview [--num-ofdm-symbols N] [--seed S] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from ofdm_tpu_torch.examples import add_link_options, record


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-ofdm-symbols", type=int, default=1000)
    add_link_options(p, seed=42)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ofdm_tpu_torch.config import EqualizationMethod, PrefixType
    from ofdm_tpu_torch.models import channels as chm
    from ofdm_tpu_torch.ops import adaptive as ad
    from ofdm_tpu_torch.ops import allocate as al
    from ofdm_tpu_torch.ops import bits as bitops
    from ofdm_tpu_torch.ops import channel as ch
    from ofdm_tpu_torch.ops import equalize as eq
    from ofdm_tpu_torch.ops import mapping as mp
    from ofdm_tpu_torch.ops import metrics as mt
    from ofdm_tpu_torch.ops import ofdm, prng

    device = torch.device("cuda" if args.device is None else args.device)
    key = prng.key_words(args.seed)
    n, snr_db, num_ofdm_symbols = 64, 20.0, args.num_ofdm_symbols
    desired_ser = 1e-3

    # --- channel -------------------------------------------------------------
    raw_ir = chm.get_channel("Lin-Phoong_P1")
    taps = torch.tensor(chm.normalize_impulse_response(raw_ir), dtype=torch.complex64, device=device)
    h_freq = chm.channel_frequency_response(raw_ir, n)
    gains = np.abs(h_freq) ** 2
    noise_power = 10 ** (-snr_db / 10)
    prefix_len = chm.channel_order(raw_ir)
    print(f"Channel: {len(raw_ir)} taps, prefix length {prefix_len}")

    # --- waterfilling + gap-function bit loading --------------------------------
    power = al.waterfilling(float(n), gains, noise_power)
    snr_per_sc = power * gains / noise_power
    orders = mp.qam_bit_loading_orders(desired_ser, snr_per_sc)
    mapper = ad.make_adaptive_mapper("QAM", orders)
    print(f"Orders: min {orders[orders>0].min()}, max {orders.max()}, "
          f"{(orders > 0).sum()}/{n} active, "
          f"{mapper.bits_per_ofdm_symbol} bits/OFDM symbol")

    # --- TX ---------------------------------------------------------------------
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    tx_bits = bitops.random_bits(prng.fold_in(key, 0), (num_ofdm_symbols, mapper.bits_per_ofdm_symbol), device)
    symbols, tx_idx = ad.encode(tx_bits, mapper)
    # Apply the power allocation (the experiment-script path; the main
    # reference path computes but does not apply it).
    symbols = symbols * torch.tensor(np.sqrt(power), dtype=torch.float32, device=device).to(symbols.dtype)
    blocks = ofdm.ofdm_modulate(symbols, n, PrefixType.CYCLIC, prefix_len)

    # --- channel ------------------------------------------------------------------
    z = prng.normal_planes(key, 0, num_ofdm_symbols, n + prefix_len, prng.AWGN_STREAM, device)
    rx_blocks, _ = ch.transmit(blocks, taps, snr_db, z=z)

    # --- RX -------------------------------------------------------------------------
    freq = ofdm.ofdm_demodulate_to_freq(rx_blocks, n, PrefixType.CYCLIC, prefix_len)
    eqd = eq.equalize(freq, torch.tensor(h_freq, dtype=torch.complex64, device=device),
                      EqualizationMethod.MMSE, snr_db)
    # Per-subcarrier normalization to unit average power before demapping
    # (reference overview.py / NORMALIZATION_FIX.md semantics).
    per_sc_power = (eqd.real * eqd.real + eqd.imag * eqd.imag).mean(dim=0, keepdim=True)
    eqd = torch.where(per_sc_power > 1e-10, eqd / per_sc_power.sqrt(), eqd)

    rx_bits, rx_idx = ad.decode(eqd, mapper)

    # --- metrics ------------------------------------------------------------------------
    total_bits = num_ofdm_symbols * mapper.bits_per_ofdm_symbol
    errors = int(mt.bit_errors(tx_bits, rx_bits))
    sym_errors = int(mt.symbol_errors(tx_idx, rx_idx))
    seconds = time.perf_counter() - t0
    print(f"BER: {errors}/{total_bits} = {errors / total_bits:.6f}")
    print(f"SER: {sym_errors / tx_idx.numel():.6f}")
    return [record("overview", "bit-level ops", {
        "hotpath_used": "cuda" if device.type == "cuda" else "torch", "bit_errors": errors,
        "total_bits": total_bits, "bit_error_rate": errors / total_bits,
        "ofdm_symbols_per_s": num_ofdm_symbols / seconds})]


if __name__ == "__main__":
    main()

"""Pod-scale Monte-Carlo sweep: 10^9+ QAM symbols, 1024 subcarriers, sharded.

The port's examples/pod_scale_sweep.py (BASELINE configs[4]): the full SNR
grid over a wide-band link (64-QAM, severe_multipath, CP ratio 1.0, MMSE;
the lr kernel at 1024 subcarriers) through ``ShardedLinkRunner``, the
OFDM-symbol batch sharded over the ranks of the process group (one rank a
card; set OFDM_TPU_COORDINATOR, OFDM_TPU_NUM_PROCS and OFDM_TPU_PROC_ID per
process, see ``parallel.mesh.distributed_init``).  On one card it still
runs, taking the ranks' count times longer.

Defaults are sized for a quick demo (2^24 QAM symbols a point); pass
--full for the 10^9-symbol run.

Run:  python -m ofdm_tpu_torch.examples.pod_scale_sweep [--full] [--subcarriers N]
                                                       [--qam-symbols Q] [--seed S] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from ofdm_tpu_torch.examples import add_link_options, link_record


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--full", action="store_true", help="10^9+ QAM symbols per point (configs[4] scale)")
    parser.add_argument("--subcarriers", type=int, default=1024)
    parser.add_argument("--qam-symbols", type=int, default=None,
                        help="QAM symbols a point (default 2^24, 2^30 with --full)")
    add_link_options(parser)
    args = parser.parse_args(argv)

    from ofdm_tpu_torch.config import ChannelType, EqualizationMethod, PrefixType, SimulationConfig
    from ofdm_tpu_torch.parallel import ShardedLinkRunner, distributed_init, make_mesh
    from ofdm_tpu_torch.pipeline import prepare

    distributed_init(backend="gloo" if args.device == "cpu" else "nccl")
    mesh = make_mesh(args.device)
    n_dev = mesh.size
    print(f"Mesh: {n_dev} device(s) — {mesh.device}")

    n = args.subcarriers
    qam_per_point = args.qam_symbols or ((1 << 30) if args.full else (1 << 24))  # 1.07e9 / 16.8M
    num_ofdm = qam_per_point // n
    num_ofdm -= num_ofdm % n_dev  # divisible across the mesh

    cfg = SimulationConfig(
        num_symbols=num_ofdm * n,
        num_subcarriers=n,
        constellation_order=64,
        channel_type=ChannelType.CUSTOM,
        channel_model="severe_multipath",
        prefix_type=PrefixType.CYCLIC,
        prefix_length_ratio=1.0,
        equalization_method=EqualizationMethod.MMSE,
        snr_db=20.0,
        symbols_per_chunk=min(num_ofdm, 8192 * n_dev),
    )
    runner = ShardedLinkRunner(prepare(cfg), mesh=mesh)

    print(f"{num_ofdm:,} OFDM symbols x {n} subcarriers per point "
          f"({cfg.num_symbols:,} QAM symbols, {cfg.num_symbols * 6:,} bits)")
    snrs = (0.0, 10.0, 20.0, 30.0)
    t0 = time.perf_counter()
    rs = runner.run_grid(args.seed, snrs)
    dt = time.perf_counter() - t0
    for r in rs:
        print(f"  SNR {r['snr_db']:5.1f} dB: BER {r['bit_error_rate']:.2e}  "
              f"{r['ofdm_symbols_per_s']:,.0f} OFDM syms/s")
    print(f"  grid wall {dt:.1f}s for {len(rs)} points "
          f"({cfg.num_symbols * len(rs) / dt / 1e6:,.1f}M QAM syms/s aggregate)")
    return [link_record(f"{r['snr_db']:.0f}db", cfg, r) for r in rs]


if __name__ == "__main__":
    main()

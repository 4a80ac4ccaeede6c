"""Export the built-in channel impulse responses as .npy assets.

The port's examples/generate_channel_models.py (the reference's
examples/generate_channel_models.py:11-143, same channel values): host
only, writes config/channel_models/<name>.npy under the working directory.

Run:  python -m ofdm_tpu_torch.examples.generate_channel_models
"""

from __future__ import annotations

import argparse


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

    from ofdm_tpu_torch.models import channels as chm

    chm.export_channel_models("config/channel_models")
    print("Generated channel impulse response models:")
    for name in chm.list_channels():
        h = chm.get_channel(name)
        print(f"  config/channel_models/{name}.npy — {len(h)} taps")
    return []


if __name__ == "__main__":
    main()

"""`python -m ofdm_tpu_torch`: the simulation-runner CLI (see ofdm_tpu_torch.main)."""

import sys

from ofdm_tpu_torch.main import main

if __name__ == "__main__":
    sys.exit(main())

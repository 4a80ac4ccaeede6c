"""Host-side utilities of the port: result management, plots, profiling,
live watching.  Importing the package needs neither matplotlib nor PIL."""

from ofdm_tpu_torch.utils.visualization import (
    plot_adaptive_constellation_diagram,
    plot_combined_constellation_analysis,
    plot_constellation_order_distribution,
    plot_water_level_diagram,
)

__all__ = [
    "plot_constellation_order_distribution",
    "plot_combined_constellation_analysis",
    "plot_water_level_diagram",
    "plot_adaptive_constellation_diagram",
]

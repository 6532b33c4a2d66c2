from repro_torch.kernels.mamba2_scan.ops import (  # noqa: F401
    launch_counts, mamba2_scan, reset_launch_counts)
from repro_torch.kernels.mamba2_scan.ref import ssd_chunked  # noqa: F401

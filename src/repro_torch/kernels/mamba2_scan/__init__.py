from repro_torch.kernels.mamba2_scan.ops import (  # noqa: F401
    launch_counts, mamba2_scan, reset_launch_counts, route_of)
from repro_torch.kernels.mamba2_scan.ref import (  # noqa: F401
    ssd_chunk_output, ssd_chunk_parallel, ssd_chunk_states, ssd_chunked,
    ssd_state_passing)
from repro_torch.kernels.mamba2_scan.autograd import (  # noqa: F401
    ssd_backward, ssd_fn)

from repro_torch.kernels.quantize.ops import (  # noqa: F401
    launch_counts, quantize_int8, quantize_pack_int8, reset_launch_counts)
from repro_torch.kernels.quantize.ref import (  # noqa: F401
    quantize_int8_ref, quantize_pack_int8_ref)

from repro_torch.kernels.block_attention.ops import (  # noqa: F401
    block_attention, launch_counts, reset_launch_counts, route_of)
from repro_torch.kernels.block_attention.ref import (  # noqa: F401
    attention_ref, attention_split_kv_ref)
from repro_torch.kernels.block_attention.autograd import (  # noqa: F401
    attention_backward, attention_fn)

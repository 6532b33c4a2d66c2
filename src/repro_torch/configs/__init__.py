from repro_torch.configs.base import SplitConfig  # noqa: F401
from repro_torch.configs.pyvertical_mnist import (CONFIG,  # noqa: F401
                                                  MLPSplitConfig)

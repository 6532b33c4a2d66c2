from repro_torch.optim.optimizers import (Optimizer,  # noqa: F401
                                          apply_updates, multi_segment, sgd)

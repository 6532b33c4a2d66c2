from repro_torch.optim.optimizers import (Optimizer, adam,  # noqa: F401
                                          adamw, apply_updates, chain,
                                          clip_by_global_norm, constant,
                                          multi_segment, sgd, warmup_cosine)

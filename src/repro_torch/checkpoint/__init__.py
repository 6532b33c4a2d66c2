from repro_torch.checkpoint.checkpoint import (restore, restore_split,  # noqa
                                               save, save_split)

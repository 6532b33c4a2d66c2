from repro_torch.data.synthetic import (  # noqa: F401
    batches, make_mnist_like, make_token_dataset, make_vertical_mnist_parties)

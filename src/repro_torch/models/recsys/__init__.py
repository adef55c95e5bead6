"""The recsys family: the embedding bags and AutoInt."""
from repro_torch.models.recsys.embedding_bag import (  # noqa: F401
    embedding_bag_dense, embedding_bag_ragged)
from repro_torch.models.recsys.autoint import (  # noqa: F401
    AutoInt, autoint_params_from_jax)

"""NCL, LightGCL (with and without edge dropout), HCCF and DCCF against the
JAX package: the tests, draws and tolerances of ``test_torch_ssl_models.py``,
collected here for these cases so that xdist spreads the two files."""

import pytest
import torch

from test_torch_ssl_models import (make_pair, prf_edge_drop,  # noqa: F401
                                   test_adam_steps_match_optax, test_generate_matches_jax,
                                   test_loss_and_grads_match_jax)

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores


@pytest.fixture(params=["ncl", "lightgcl", "lightgcl_dropout", "hccf", "dccf"])
def pair(request, tiny_bundle, prf_edge_drop):  # noqa: F811
    return make_pair(request.param, tiny_bundle, prf_edge_drop)

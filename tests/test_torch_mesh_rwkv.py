"""rwkv6's smoke model on DTensor parameters: the port's serve and train
step on (1, 2) and (2, 1) meshes against the JAX package's two-device run
(``tests/torch_mesh_models.py`` holds the runs and the tests). The chunked
WKV scan runs on each rank's heads (``models/heads.py``).

The ranks import ``torch_mesh_models``, not this module."""

from torch_mesh_models import (  # noqa: F401 (the fixture and the tests)
    pytest_generate_tests, runs, test_abft_tree_check_on_dtensor_leaves,
    test_caches_and_parameters_where_the_specs_put_them,
    test_prefill_routes_as_jax, test_sampling_draws_as_one_process,
    test_serve_tokens_and_logits_as_jax, test_train_losses_as_jax,
    test_train_parameters_as_jax)

ARCH = "rwkv6-1.6b"

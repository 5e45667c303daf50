"""deepseek-v3's smoke model on DTensor parameters: the port's serve and
train step against the JAX package's two-device run
(``tests/torch_mesh_models.py`` holds the runs and the tests): mixtral's
cases (``MOE_CASES``) and the non-absorbed MLA decode on (1, 2). MLA's
decode attends over each rank's heads with the sequence-parallel latent
cache gathered (``models/attention.py``).

The ranks import ``torch_mesh_models``, not this module."""

from torch_mesh_models import (  # noqa: F401 (the fixture and the tests)
    pytest_generate_tests, runs, test_abft_tree_check_on_dtensor_leaves,
    test_caches_and_parameters_where_the_specs_put_them,
    test_moe_metrics_and_router_bias_gradient_as_jax,
    test_prefill_routes_as_jax, test_router_bias_update_on_dtensor_leaves,
    test_sampling_draws_as_one_process,
    test_serve_tokens_and_logits_as_jax, test_train_losses_as_jax,
    test_train_parameters_as_jax)

ARCH = "deepseek-v3-671b"

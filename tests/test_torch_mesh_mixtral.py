"""mixtral's smoke model on DTensor parameters: the port's serve and train
step against the JAX package's two-device run (``tests/torch_mesh_models.
py`` holds the runs and the tests): expert parallelism on (1, 2), one
dispatch group over both dp ranks and two groups on (2, 1), 3 experts
splitting their d_ff over "model" on (1, 2), FSDP on (2, 1). The
dispatch and the expert products run on each rank's local tensors
(``models/moe.py``); the caches are 16-slot rings.

The ranks import ``torch_mesh_models``, not this module."""

from torch_mesh_models import (  # noqa: F401 (the fixture and the tests)
    pytest_generate_tests, runs, test_abft_tree_check_on_dtensor_leaves,
    test_caches_and_parameters_where_the_specs_put_them,
    test_moe_metrics_and_router_bias_gradient_as_jax,
    test_prefill_routes_as_jax, test_router_bias_update_on_dtensor_leaves,
    test_sampling_draws_as_one_process,
    test_serve_tokens_and_logits_as_jax, test_train_losses_as_jax,
    test_train_parameters_as_jax)

ARCH = "mixtral-8x7b"

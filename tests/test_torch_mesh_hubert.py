"""hubert's smoke model (4 layers) on DTensor parameters: the port's
encoder serve (``forward`` and ``prefill`` of frames) and train step on
(1, 2) and (2, 1) meshes against the JAX package's two-device run
(``tests/torch_mesh_models.py`` holds the runs and the tests). The frame
projection's output, sharded on d_model over "model", is gathered there
(``models.model._embed_input``); the GELU MLP's ``b_up`` meets w_up's
"model"-sharded output, and the replicated ``b_down`` joins w_down's
pending sum once.

The ranks import ``torch_mesh_models``, not this module."""

from torch_mesh_models import (  # noqa: F401 (the fixture and the tests)
    pytest_generate_tests, runs, test_abft_tree_check_on_dtensor_leaves,
    test_caches_and_parameters_where_the_specs_put_them,
    test_encoder_logits_and_caches_as_jax, test_encoder_prefill_routes_as_jax,
    test_train_losses_as_jax, test_train_parameters_as_jax)

ARCH = "hubert-xlarge"

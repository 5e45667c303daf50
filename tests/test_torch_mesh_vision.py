"""llama-3.2-vision's smoke model on DTensor parameters: the port's serve
(``generate(extras=)`` with seeded f32 image embeddings) and train step
(the pipeline's image embeddings) on (1, 2) and (2, 1) meshes against
the JAX package's two-device run (``tests/torch_mesh_models.py`` holds
the runs and the tests). The image K/V come out of ``kv_proj_*``
sharded on their last dim over "model", their heads then line up with
``wq``'s; the cross attention runs on each rank's heads
(``models/heads.py``); the 0-d gates are replicated DTensors that scale
the sharded stream; the cross caches, replaced by the prefill, lie where
``cache_specs`` puts them after a prefill and a decode step.

The ranks import ``torch_mesh_models``, not this module."""

from torch_mesh_models import (  # noqa: F401 (the fixture and the tests)
    pytest_generate_tests, runs, test_abft_tree_check_on_dtensor_leaves,
    test_caches_and_parameters_where_the_specs_put_them,
    test_prefill_routes_as_jax, test_sampling_draws_as_one_process,
    test_serve_tokens_and_logits_as_jax, test_train_losses_as_jax,
    test_train_parameters_as_jax)

ARCH = "llama-3.2-vision-11b"
